"""The PPO loss head's plain version (``ops/cuda/ppo_loss.py``, the
kernel's counterpart on CPU tensors) against autograd through
``parallel.ppo.loss_fn`` in float64; its autograd binding; the CPU route of
``loss_fn``, which keeps its autograd chain; and the benchmark's reader of
the kernel's launch count. The kernel itself is held to the same
reference on the card in ``test_torch_gpu_kernels.py``.

    python -m pytest tests/test_torch_ppo_loss.py -q
"""
from __future__ import annotations

import os

import pytest
import torch

from sustaingym_tpu_torch.ops.cuda import ppo_loss as K
from sustaingym_tpu_torch.parallel import PPOConfig, ppo
from tests._ppo_loss_cases import CASES, args_of, gaps, make_case, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("act_dim,rows", [(1, 37), (7, 1001), (54, 333)])
def test_plain_version_matches_autograd_float64(act_dim, rows, strided, case,
                                                ent_coef):
    """Loss, pg, vf, ent and the three gradients of the plain version
    against autograd through ``loss_fn``, both in float64, on row counts
    that are no multiple of a block; ratios inside the clip range,
    beyond it, exactly at both bounds (with both advantage signs), and
    advantages of std 0."""
    c = make_case(case, rows, act_dim, ent_coef, strided)
    want, scale = reference(c)
    got = K.ppo_gauss_loss(*args_of(c))
    assert got[0].dtype == torch.float64
    for name, gap in gaps(got, want, scale).items():
        assert gap < 1e-12, (name, gap)
    if case == "const_adv":
        assert float(got[1]) == 0.0 and not got[4].any()


@pytest.mark.parametrize("case", CASES)
def test_plain_version_float32_within_float64(case):
    """The plain version in float32 stays within 1e-5 of each output's
    float64 scale, at the EV head's width (the float32 cases the card's
    test holds the kernel to)."""
    c32 = make_case(case, 2048, 54, 0.01, True, dtype=torch.float32,
                    exact=False)
    want, scale = reference(c32)
    got = K.ppo_gauss_loss(*args_of(c32))
    assert got[4].dtype == torch.float32
    for name, gap in gaps(got, want, scale).items():
        assert gap < 1e-5, (name, gap)


@pytest.mark.parametrize("grad_scale", [1.0, 2.5])
@pytest.mark.parametrize("whole", [True, False])
def test_binding_returns_the_saved_gradients_scaled(grad_scale, whole):
    """:func:`fused_ppo_loss`'s backward gives the plain version's
    gradients times the incoming one: to the head product whole where
    ``mu`` and ``value`` are its two parts, else to each; pg, vf and ent
    carry no gradient."""
    c = make_case("beyond", 101, 7, 0.01, True)
    want, _ = reference(c)
    head = c["head"].clone().requires_grad_(True)
    log_std = c["log_std"].clone().requires_grad_(True)
    mu, value = head[:, :7], head[:, 7]
    if not whole:
        mu, value = mu * 1.0, value * 1.0
    assert (K.head_of(mu, value) is head) == whole
    loss, pg, vf, ent = K.fused_ppo_loss(mu, log_std, value,
                                         *args_of(c)[3:])
    assert not (pg.requires_grad or vf.requires_grad or ent.requires_grad)
    (loss * grad_scale).backward()
    torch.testing.assert_close(head.grad[:, :7], grad_scale * want["d_mu"],
                               rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(head.grad[:, 7], grad_scale * want["d_value"],
                               rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(log_std.grad, grad_scale * want["d_log_std"],
                               rtol=1e-12, atol=1e-15)
    for x, name in ((loss, "loss"), (pg, "pg"), (vf, "vf"), (ent, "ent")):
        torch.testing.assert_close(x.detach(), want[name], rtol=1e-12,
                                   atol=1e-15)


def test_loss_fn_on_the_cpu_keeps_its_autograd_chain(monkeypatch):
    """CPU head outputs never take the fused path: ``loss_fn`` gives the
    same numbers with the binding made to fail, and the kernel counts no
    launch."""
    c = make_case("inside", 64, 7, 0.0, False)
    want, _ = reference(c)

    def refuse(*a, **k):
        raise AssertionError("the fused loss head ran on CPU tensors")
    monkeypatch.setattr(ppo, "fused_ppo_loss", refuse)
    before = K.ppo_gauss_loss.launches
    ref_again, _ = reference(c)
    assert K.ppo_gauss_loss.launches == before
    for name in want:
        assert torch.equal(want[name], ref_again[name]), name


def test_head_of_finds_the_one_head_product():
    """``mu`` and ``value`` are recognised as the two parts of one (rows,
    A + 1) product only in that layout: not as other columns, not from a
    strided product, not as copies."""
    head = torch.zeros((6, 4))
    assert K.head_of(head[:, :3], head[:, 3]) is head
    assert K.head_of(head[:, :3], head[:, 2]) is None
    assert K.head_of(head[:, 1:], head[:, 0]) is None
    assert K.head_of(head[:, :3].clone(), head[:, 3]) is None
    wide = torch.zeros((6, 8))[:, :4]
    assert K.head_of(wide[:, :3], wide[:, 3]) is None
    d = K.ppo_gauss_loss(head[:, :3], torch.zeros(3), head[:, 3],
                         torch.zeros((6, 3)), torch.zeros(6),
                         torch.arange(6.0), torch.zeros(6), 0.2, 0.5,
                         0.0)[4:6]
    assert d[0]._base is d[1]._base and d[0]._base.shape == (6, 4)


def test_fused_path_gate_reads_the_head_outputs():
    """The fused path's gate is the head's kind and the device alone: a
    Gaussian head without mask, not uniform-obs, on one rank, clipped PPO,
    on a CUDA device. The kernel's own check (``check_head``) raises for
    head outputs it cannot take (float64, a per-agent (rows, n_agents, A)
    head, a width beyond the kernel's, a column stride), so no such head
    leaves the kernel unseen."""
    from types import SimpleNamespace
    cfg = PPOConfig()
    card = SimpleNamespace(device=torch.device("cuda"))
    assert ppo.fused_head(card, cfg)
    assert not ppo.fused_head(torch.zeros((8, 3)), cfg)
    assert not ppo.fused_head(card, cfg, n_bins=3)
    assert not ppo.fused_head(card, cfg, mask=torch.ones((2, 3)))
    assert not ppo.fused_head(card, cfg, uma=True)
    assert not ppo.fused_head(card, cfg, red=object())
    assert not ppo.fused_head(card, PPOConfig(algo="a2c"))
    K.check_head(torch.zeros((8, 3)), torch.zeros(3), torch.zeros(8))
    head = torch.zeros((8, 4))
    K.check_head(head[:, :3], torch.zeros(3), head[:, 3])
    for mu, log_std, value in (
            (torch.zeros((8, 3), dtype=torch.float64), torch.zeros(3),
             torch.zeros(8)),
            (torch.zeros((8, 2, 3)), torch.zeros((2, 3)), torch.zeros((8, 2))),
            (torch.zeros((8, K.MAX_ACT_DIM + 1)),
             torch.zeros(K.MAX_ACT_DIM + 1), torch.zeros(8)),
            (torch.zeros((3, 8)).t(), torch.zeros(3), torch.zeros(8)),
            (torch.zeros((8, 3)), torch.zeros(4), torch.zeros(8)),
            (torch.zeros((8, 3)), torch.zeros(3), torch.zeros(7))):
        with pytest.raises(ValueError):
            K.check_head(mu, log_std, value)


def test_train_step_on_the_cpu_runs_no_fused_pass():
    """A CPU PPO step (EV, float32 obs) reports the losses of the autograd
    chain and launches no fused pass."""
    from sustaingym_tpu_torch import make
    env, p = make("evcharging", device="cpu", project_action=False)
    cfg = PPOConfig(num_envs=4, rollout_len=8, hidden=16, minibatches=2,
                    epochs=1)
    init_state, step = ppo.make_train_step(env, p, cfg)
    g = torch.Generator().manual_seed(3)
    before = K.ppo_gauss_loss.launches
    _, m = step(init_state(g), g)
    assert K.ppo_gauss_loss.launches == before
    assert all(torch.isfinite(m[k]) for k in ppo.METRICS)


def _reader():
    import sys
    sys.path.insert(0, ROOT)
    from h100_bench.lib import spec
    return spec.module("metrics", "learner.fused_loss_launches_per_step")


@pytest.mark.parametrize("launches,want", [({"ppo_gauss_loss": 1152}, 384.0),
                                           ({"ev_policy_segment": 3}, None),
                                           ({}, None)])
def test_fused_loss_launches_reader(launches, want):
    """The benchmark's reader: the wrapper's launches over the pass's
    units (1152 over 3 steps is 384), None where the program has no fused
    pass or no traced pass at all."""
    read = _reader().read
    ctx = {"extras": {}, "program": {
        "units": 3, "pool_bytes": None, "profiled": None,
        "light": {"spans": [], "counters": {}, "launches": launches}}}
    assert read(ctx) == want
    assert read({"extras": {}}) is None
    assert read({"extras": {}, "program": None}) is None
