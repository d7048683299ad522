"""The port's pack directories (sustaingym_tpu_torch.data.paths): every
writer of the port writes into the port's own pack directory, and nothing
it does, at its defaults, creates or changes a file under
``sustaingym_tpu/``, the JAX package's tree the parity tests read as the
reference.

The writers run on the synthetic raw tree of ``tests/test_torch_etl.py``
(its ``raw`` fixture) and on a GMM pickle of ``tests/test_torch_gmm_fit.py``
(``_write_pickle``). Only the port's pack directory is moved to
``tmp_path``; its committed packs stay where the JAX package keeps them.
"""
import hashlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.data import cogen_etl as tcogen
from sustaingym_tpu_torch.data import ev_etl as tev
from sustaingym_tpu_torch.data import ev_gmm as tgmm
from sustaingym_tpu_torch.data import paths as tpaths
from tests.test_torch_etl import PERIOD, STATIONS, raw  # noqa: F401
from tests.test_torch_gmm_fit import _write_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TREE = os.path.join(REPO, "sustaingym_tpu")
PORT_DATA = os.path.join(REPO, "sustaingym_tpu_torch", "data")
GMM3 = os.path.join("caltech", "2021-05-01_2021-08-31_3.npz")
ENVS = ("evcharging", "cogen", "datacenter", "electricitymarket")


def _snapshot(root: str) -> dict:
    """Every file under ``root`` but ``__pycache__``: its path relative to
    ``root``, size and SHA-256."""
    out = {}
    for d, subdirs, files in os.walk(root):
        subdirs[:] = [s for s in subdirs if s != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()
            out[os.path.relpath(path, root)] = (os.path.getsize(path), digest)
    return out


def _files(root) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files}


@pytest.fixture
def port_dir(raw, tmp_path, monkeypatch):  # noqa: F811
    """The port's pack directory at tmp_path/port (absent), the raw root
    at the synthetic tree; the committed packs where they are."""
    monkeypatch.setattr(tpaths, "PACKED_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(tpaths, "_DEFAULT_RAW_CANDIDATES", ("", raw))
    return tmp_path / "port"


def test_writers_leave_the_jax_tree_alone(port_dir, raw):  # noqa: F811
    """Each writer at its defaults: the JAX tree and the port's data
    directory are as they were, and every file written is under
    tmp_path."""
    assert tpaths.COMMITTED_DIR == os.path.join(JAX_TREE, "data", "packed")
    assert tgmm.GMM_NPZ_DIR == os.path.join(JAX_TREE, "data", "gmm")
    jax_before, port_before = _snapshot(JAX_TREE), _snapshot(PORT_DATA)

    assert tev.build_moer_pack(PERIOD).shape == (4, 289, 37)
    for cap in (100.0, 150.0):
        tev.build_trace_pack("caltech", PERIOD, STATIONS,
                             requested_energy_cap=cap)
    assert tcogen.build_ambients_pack(37.5).shape == (16, 96, 7)
    # the pickle's three components under a name nothing commits
    pkl = _write_pickle(raw, pickle.DEFAULT_PROTOCOL)
    os.replace(pkl, pkl.replace(" 30.pkl", " 3.pkl"))
    exported = tgmm.export_gmm_npz("caltech", "Summer 2021", 3)
    assert exported == str(port_dir / "gmm" / GMM3)
    os.remove(exported)
    loaded = tgmm.load_gmm("caltech", "Summer 2021", n_components=3)
    assert loaded["weights"].shape == (3,)
    os.remove(pkl.replace(" 30.pkl", " 3.pkl"))
    for name in ENVS:
        make(name, device="cpu")

    assert _snapshot(JAX_TREE) == jax_before
    assert _snapshot(PORT_DATA) == port_before
    assert _files(port_dir) == {
        "moer_SGIP_CAISO_SCE_2021-05-30_2021-06-02.npz",
        "evtrace_caltech_2021-05-30_2021-06-02_0.npz",
        "evtrace_caltech_2021-05-30_2021-06-02_0_cap=150.0.npz",
        "cogen_ambients_wind=37.5.npz",
        os.path.join("gmm", GMM3)}


def test_the_port_directory_wins_over_the_committed_one(port_dir):
    name = "cogen_ambients_wind=100.0.npz"
    committed = os.path.join(tpaths.COMMITTED_DIR, name)
    assert tpaths.find_pack(name) == committed
    shipped = np.load(committed)["ambients"]
    port_dir.mkdir()
    np.savez(port_dir / name, ambients=shipped[:3] + 1)
    assert tpaths.find_pack(name) == str(port_dir / name)
    np.testing.assert_array_equal(tcogen.build_ambients_pack(100.0),
                                  shipped[:3] + 1)
    assert tpaths.find_pack("no_such_pack.npz") is None


def test_a_read_creates_no_directory(port_dir):
    make("evcharging", device="cpu")
    tgmm.build_gmm_trace_pack("caltech", "Summer 2021", n_days=10)
    assert not port_dir.exists()


def test_the_default_pack_directory_is_the_ports():
    """Without an override the port writes into its own pack directory,
    outside the JAX tree, and reads the committed packs from the JAX
    package's."""
    code = ("from sustaingym_tpu_torch.data import paths; "
            "print(paths.PACKED_DIR); print(paths.COMMITTED_DIR)")
    env = {k: v for k, v in os.environ.items() if k != "SUSTAINGYM_PACKED"}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    packed, committed = run.stdout.split()
    assert packed == os.path.join(PORT_DATA, "packed")
    assert os.path.commonpath((packed, JAX_TREE)) != JAX_TREE
    assert committed == os.path.join(JAX_TREE, "data", "packed")


def test_an_override_still_finds_the_committed_packs(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    code = ("from sustaingym_tpu_torch import make; "
            "from sustaingym_tpu_torch.data import paths; "
            f"assert paths.PACKED_DIR == {str(empty)!r}; "
            "env, p = make('evcharging', device='cpu'); "
            "print(p.n_days)")
    env = {**os.environ, "SUSTAINGYM_PACKED": str(empty)}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert int(run.stdout.split()[-1]) == 123    # 2021-05-01 .. 2021-08-31
    assert os.listdir(empty) == []


@pytest.mark.parametrize("where", ["committed", "jax_tree", "symlink"])
def test_the_write_path_refuses_the_jax_tree(where, raw,  # noqa: F811
                                             tmp_path, monkeypatch):
    target = {"committed": tpaths.COMMITTED_DIR,
              "jax_tree": os.path.join(JAX_TREE, "data", "port_packs"),
              "symlink": str(tmp_path / "link" / "packed")}[where]
    if where == "symlink":
        os.symlink(os.path.join(JAX_TREE, "data"), tmp_path / "link")
    monkeypatch.setattr(tpaths, "PACKED_DIR", target)
    monkeypatch.setattr(tpaths, "_DEFAULT_RAW_CANDIDATES", ("", raw))
    before = _snapshot(JAX_TREE)
    with pytest.raises(ValueError, match="JAX package's tree"):
        tpaths.pack_out_path("x.npz")
    with pytest.raises(ValueError, match="JAX package's tree"):
        tev.build_moer_pack(PERIOD)
    assert _snapshot(JAX_TREE) == before
    assert not os.path.exists(os.path.join(JAX_TREE, "data", "port_packs"))
