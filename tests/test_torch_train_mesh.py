"""``train.py --mesh N --mp M`` on the CPU: launched alone it spawns its
N gloo ranks, rank 0 writes the CSV and the checkpoints, and a checkpoint
taken under an mp split holds the one-rank format, so ``--restore`` works
at any mesh; and ``from_jax`` with a mesh keeps a rank's shard."""
import csv
import os

import numpy as np
import torch

from sustaingym_tpu_torch import train
from sustaingym_tpu_torch.parallel import from_jax, init_policy, to_jax
from sustaingym_tpu_torch.parallel.mesh import Mesh

ARGS = ["--device", "cpu", "--env", "evcharging", "--num-envs", "8",
        "--rollout-len", "16", "--hidden", "16", "--minibatches", "2",
        "--epochs", "1", "--save-every", "2"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_train_cli_mesh_checkpoints_restore_at_any_mesh(tmp_path):
    split = str(tmp_path / "split")
    train.main(ARGS + ["--iterations", "2", "--mesh", "2", "--mp", "2",
                       "--log-dir", split])
    rows = _rows(os.path.join(split, "train_results.csv"))
    assert [int(r["iteration"]) for r in rows] == [0, 1]   # rank 0 only
    ckpt = torch.load(os.path.join(split, "checkpoints", "step_2.pt"),
                      weights_only=True)
    policy = ckpt["carry"]["policy"]
    assert policy["trunk1.weight"].shape == (16, 146)     # gathered
    assert policy["trunk2.weight"].shape == (16, 16)
    shapes = {tuple(v["exp_avg"].shape)
              for v in ckpt["carry"]["opt"]["state"].values()}
    assert {(16, 146), (16, 16), (16,)} <= shapes   # Adam's, gathered
    assert ckpt["carry"]["env_states"][0].shape[0] == 8
    for mesh, log in ((["--mesh", "0"], "one"), (["--mesh", "2"], "dp2")):
        out = str(tmp_path / log)
        train.main(ARGS + ["--iterations", "1", "--restore",
                           os.path.join(split, "checkpoints"),
                           "--log-dir", out] + mesh)
        rows = _rows(os.path.join(out, "train_results.csv"))
        assert [int(r["iteration"]) for r in rows] == [2]
        assert np.isfinite(float(rows[0]["pg_loss"]))


def test_from_jax_keeps_a_ranks_shard():
    full = init_policy(6, 2, 8, torch.Generator().manual_seed(0))
    tree = to_jax(full)
    mesh = Mesh(dp=1, mp=2, d=0, m=1, device=torch.device("cpu"))
    part = from_jax(tree, device="cpu", mesh=mesh)
    assert torch.equal(part.trunk1.weight, full.trunk1.weight[4:])
    assert torch.equal(part.trunk1.bias, full.trunk1.bias[4:])
    assert torch.equal(part.trunk2.weight, full.trunk2.weight[:, 4:])
    assert torch.equal(part.trunk2.bias, full.trunk2.bias)
    assert torch.equal(part.mu.weight, full.mu.weight)
