"""The port's GMM fit, CLI and export (sustaingym_tpu_torch.data.ev_gmm)
against sklearn and the JAX package's data.ev_gmm.

The raw sessions are the synthetic tree of ``tests/test_torch_etl.py``
(``_write_sessions``: five days, claimed and unclaimed rows, two stations
outside caltech's network). The other data set is a draw of 5832 sessions
from the committed jpl Summer 2019 export, kept inside the feature domain
(5821 rows). Both packages' raw roots, pack directories and GMM export
directories, and the port's committed-pack directory, point into
``tmp_path``; the committed exports are hashed before and after the
module.
"""
import glob
import hashlib
import io
import os
import pickle
import re
import subprocess
import sys
import warnings

import numpy as np
import pandas as pd
import pytest
import sklearn.mixture
import torch
from sklearn.cluster import KMeans
from sklearn.exceptions import ConvergenceWarning

from sustaingym_tpu.data import ev_gmm as jgmm
from sustaingym_tpu.data import paths as jpaths
from sustaingym_tpu_torch.data import ev_gmm as tgmm
from sustaingym_tpu_torch.data import paths as tpaths
from sustaingym_tpu_torch.envs.evcharging.sites import load_site
from tests.test_torch_etl import STATIONS, _write_sessions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERIOD = "Summer 2021"
DAYS = 123                                    # 2021-05-01 .. 2021-08-31
COMMITTED = sorted(glob.glob(os.path.join(tgmm.GMM_NPZ_DIR, "*", "*.npz")))
PKL = os.path.join("evcharging", "gmms", "caltech",
                   "2021-05-01 2021-08-31 30.pkl")
NPZ = os.path.join("caltech", "2021-05-01_2021-08-31_30.npz")
# the EM's gates against sklearn and the JAX package
PARAM_TOL, LB_TOL = 1e-6, 1e-8


def _digests():
    out = {}
    for path in COMMITTED:
        with open(path, "rb") as f:
            out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module", autouse=True)
def committed_exports_unchanged():
    before = _digests()
    yield
    assert _digests() == before


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    _write_sessions(root, np.random.default_rng(13))
    return root


def _point(monkeypatch, raw, tmp_path):
    for paths, sub in ((jpaths, "jax"), (tpaths, "port")):
        monkeypatch.setattr(paths, "PACKED_DIR", str(tmp_path / sub))
        monkeypatch.setattr(paths, "_DEFAULT_RAW_CANDIDATES", ("", raw))
    monkeypatch.setattr(tpaths, "COMMITTED_DIR",
                        str(tmp_path / "port_committed"))
    monkeypatch.setattr(jgmm, "GMM_NPZ_DIR", str(tmp_path / "jax_gmm"))
    monkeypatch.setattr(tgmm, "GMM_NPZ_DIR", str(tmp_path / "port_gmm"))


@pytest.fixture
def dirs(raw, tmp_path, monkeypatch):
    """Both packages at the synthetic tree, every output under tmp_path."""
    _point(monkeypatch, raw, tmp_path)
    return tmp_path


class _Recording(sklearn.mixture.GaussianMixture):
    """A GaussianMixture that keeps the X it was fitted on."""
    seen: list = []

    def fit(self, X, y=None):
        _Recording.seen.append(np.array(X))
        return super().fit(X, y)


def jax_fit(monkeypatch, date_period, n_components=8, seed=42):
    """The JAX fit_gmm's result and the X it handed to sklearn."""
    _Recording.seen = []
    monkeypatch.setattr(sklearn.mixture, "GaussianMixture", _Recording)
    model = jgmm.fit_gmm("caltech", date_period, n_components, seed)
    (X,) = _Recording.seen
    return model, X


def _sessions(raw):
    df = pd.read_csv(os.path.join(raw, "evcharging", "acn_data", "caltech",
                                  "2021-05-01 2021-08-31.csv.gz"))
    df = df[df["claimed"]]
    df["day"] = pd.to_datetime(df["arrival"], utc=True).dt.tz_convert(
        "America/Los_Angeles").dt.date
    return df


@pytest.fixture(scope="module")
def jpl_draw():
    """5832 sessions drawn from the committed jpl Summer 2019 export, kept
    inside the feature domain: 5821 rows."""
    with np.load(os.path.join(tgmm.GMM_NPZ_DIR, "jpl",
                              "2019-05-01_2019-08-31_30.npz")) as d:
        s = tgmm.sample_gmm(d["weights"], d["means"], d["covariances"],
                            int(d["count"].sum()), 0)
    X = s[((s[:, :3] >= 0) & (s[:, :3] < 1)).all(1) & (s[:, 3] >= 0)]
    assert X.shape == (5821, 4)
    return X


def _assert_fit_close(got: dict, sk):
    for ours, theirs in (("weights", "weights_"), ("means", "means_"),
                         ("covariances", "covariances_")):
        np.testing.assert_allclose(got[ours], getattr(sk, theirs), rtol=0,
                                   atol=PARAM_TOL, err_msg=ours)
    assert abs(got["lower_bound"] - sk.lower_bound_) < LB_TOL
    assert got["n_iter"] == sk.n_iter_
    assert got["converged"] == sk.converged_


def test_session_features_equal_the_jax_fit_input(dirs, monkeypatch):
    """On a default period the port's features are bit-equal to the X the
    JAX fit_gmm hands to sklearn."""
    _, want = jax_fit(monkeypatch, PERIOD)
    got, _, _ = tgmm.session_features("caltech", PERIOD)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape and got.shape[1] == 4
    assert got.tobytes() == want.tobytes()


def test_count_and_station_usage_in_the_export_form(dirs, raw):
    _, count, usage = tgmm.session_features("caltech", PERIOD)
    df = _sessions(raw)
    days = pd.date_range("2021-05-01", "2021-08-31").date
    assert count.dtype == np.float64 and count.shape == (DAYS,)
    session_days = sorted(set(df["day"]))
    assert len(session_days) == 5
    for i, day in enumerate(days):
        assert count[i] == (df["day"] == day).sum()
    assert (count == 0).sum() == DAYS - 5
    assert count.sum() == len(df)
    stations = load_site("caltech").station_ids
    assert usage.dtype == np.int32 and usage.shape == (len(stations),) \
        == (54,)
    np.testing.assert_array_equal(
        usage, [(df["station_id"] == s).sum() for s in stations])
    outside = df["station_id"].isin(["XX-1", "XX-2"]).sum()
    assert outside > 0 and usage.sum() == len(df) - outside
    # a committed export has the same form
    with np.load(os.path.join(REPO, "sustaingym_tpu", "data", "gmm",
                              NPZ)) as d:
        assert d["count"].dtype == count.dtype
        assert d["count"].shape == count.shape
        assert d["station_usage"].dtype == usage.dtype
        assert d["station_usage"].shape == usage.shape


def test_jax_fit_count_and_usage_form_pinned(dirs, monkeypatch, raw):
    """The JAX fit_gmm's count has one entry per day with sessions, and
    its station_usage is a frequency-sorted Series by station id that
    holds the out-of-network stations: not the export's form, which its
    own sampler reads by position."""
    model, _ = jax_fit(monkeypatch, PERIOD)
    assert len(model["count"]) == 5
    assert isinstance(model["station_usage"], pd.Series)
    assert {"XX-1", "XX-2"} <= set(model["station_usage"].index)
    assert len(model["station_usage"]) == 56
    assert list(model["station_usage"]) == sorted(
        model["station_usage"], reverse=True)


@pytest.mark.parametrize("data", ["synthetic", "jpl"])
@pytest.mark.parametrize("k", [8, 30])
def test_kmeans_labels_equal_sklearn(data, k, dirs, jpl_draw):
    X = (tgmm.session_features("caltech", PERIOD)[0] if data == "synthetic"
         else jpl_draw)
    for seed in (0, 1, 42):
        got = tgmm.kmeans_labels(X, k, np.random.RandomState(seed))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ConvergenceWarning)
            want = KMeans(k, n_init=1, random_state=np.random.RandomState(
                seed)).fit(X).labels_
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("k", [8, 30])
def test_em_from_given_parameters_equals_sklearn(k, jpl_draw):
    """The EM alone, from given weights, means and precisions, against
    sklearn's *_init fit on the same data."""
    X = jpl_draw
    rs = np.random.default_rng(k)
    weights = rs.dirichlet(np.full(k, 5.0))
    means = X[rs.choice(len(X), k, replace=False)]
    precisions = np.stack([np.linalg.inv(np.cov(X.T) * rs.uniform(0.05, 0.2))
                           for _ in range(k)])
    sk = sklearn.mixture.GaussianMixture(
        k, weights_init=weights, means_init=means,
        precisions_init=precisions).fit(X)
    got = tgmm.em_fit(X, weights_init=weights, means_init=means,
                      precisions_init=precisions, device="cpu")
    _assert_fit_close(got, sk)


def test_whole_fit_equals_sklearn(jpl_draw):
    """k-means labels and EM at (k = 30, seed = 42) against
    GaussianMixture(30, random_state=42).fit: lower bound 4.72735 after 25
    iterations; the labels of the final E-step are sklearn's predict."""
    sk = sklearn.mixture.GaussianMixture(30, random_state=42).fit(jpl_draw)
    labels = tgmm.kmeans_labels(jpl_draw, 30, np.random.RandomState(42))
    got = tgmm.em_fit(jpl_draw, labels, n_components=30, device="cpu")
    _assert_fit_close(got, sk)
    assert got["n_iter"] == 25 and abs(got["lower_bound"] - 4.72735) < 1e-5
    np.testing.assert_array_equal(got["labels"], sk.predict(jpl_draw))


def test_fit_gmm_equals_the_jax_fit(dirs, monkeypatch):
    """The port's fit_gmm on the synthetic tree at 8 components, seed 42,
    against the JAX fit_gmm's sklearn mixture."""
    model, _ = jax_fit(monkeypatch, PERIOD)
    got = tgmm.fit_gmm("caltech", PERIOD, 8, 42, device="cpu")
    _assert_fit_close(got, model["gmm"])
    with np.load(os.path.join(REPO, "sustaingym_tpu", "data", "gmm",
                              NPZ)) as committed:
        for key in tgmm._NPZ_KEYS:
            assert got[key].dtype == committed[key].dtype


def _write_pickle(raw, protocol, **extra):
    X = np.random.default_rng(3).normal(size=(200, 4))
    gmm = sklearn.mixture.GaussianMixture(3, random_state=0).fit(X)
    ref = {"gmm": gmm,
           "count": pd.Series(np.arange(DAYS, dtype=np.float64) % 7),
           "station_usage": np.arange(54, dtype=np.int32) * 2, **extra}
    path = os.path.join(raw, PKL)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(ref, f, protocol=protocol)
    return path


@pytest.fixture
def pkl_dirs(tmp_path, monkeypatch):
    """Both packages at a raw tree under tmp_path that holds only the
    GMM pickle's directory."""
    raw = tmp_path / "raw"
    raw.mkdir()
    _point(monkeypatch, str(raw), tmp_path)
    return tmp_path


def _equal_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x) == sorted(y) == sorted(tgmm._NPZ_KEYS)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("protocol", [2, 5])
def test_export_equals_the_jax_export(protocol, pkl_dirs, monkeypatch):
    _write_pickle(str(pkl_dirs / "raw"), protocol)
    want = jgmm.export_gmm_npz("caltech", PERIOD)
    got = tgmm.export_gmm_npz("caltech", PERIOD)
    assert want == str(pkl_dirs / "jax_gmm" / NPZ)
    assert got == str(pkl_dirs / "port" / "gmm" / NPZ)
    _equal_npz(got, want)
    monkeypatch.setattr(tpaths, "PACKED_DIR", str(pkl_dirs / "o"))
    out = tgmm.export_gmm_npz("caltech", PERIOD)
    assert out == str(pkl_dirs / "o" / "gmm" / NPZ)
    _equal_npz(out, want)


def test_export_runs_without_sklearn(pkl_dirs):
    _write_pickle(str(pkl_dirs / "raw"), pickle.DEFAULT_PROTOCOL)
    want = jgmm.export_gmm_npz("caltech", PERIOD)
    out = str(pkl_dirs / "nosk")
    code = ("import sys; sys.modules['sklearn'] = None; "
            "from sustaingym_tpu_torch.data import ev_gmm; "
            f"print(ev_gmm.export_gmm_npz('caltech', {PERIOD!r})); "
            "assert sys.modules['sklearn'] is None; "
            "assert not [m for m in sys.modules if m.startswith('sklearn.')]")
    env = {**os.environ, "SUSTAINGYM_RAW": str(pkl_dirs / "raw"),
           "SUSTAINGYM_PACKED": out}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == os.path.join(out, "gmm", NPZ)
    _equal_npz(os.path.join(out, "gmm", NPZ), want)


class _Evil:
    def __init__(self, fn, arg):
        self.fn, self.arg = fn, arg

    def __reduce__(self):
        return self.fn, (self.arg,)


@pytest.mark.parametrize("fn", [os.system, eval])
def test_export_refuses_other_callables(fn, pkl_dirs):
    _write_pickle(str(pkl_dirs / "raw"), pickle.DEFAULT_PROTOCOL,
                  payload=_Evil(fn, "1"))
    with pytest.raises(pickle.UnpicklingError, match=fn.__name__):
        tgmm.export_gmm_npz("caltech", PERIOD)
    assert not os.path.exists(pkl_dirs / "port" / "gmm" / NPZ)


class _Resolved(Exception):
    pass


class _Resolver(pickle.Unpickler):
    """Stops at the first global, carrying what plain pickle finds."""

    def find_class(self, module, name):
        raise _Resolved(super().find_class(module, name))


def _str_op(s):
    b = s.encode()
    return b"\x8c" + bytes([len(b)]) + b      # SHORT_BINUNICODE


@pytest.mark.parametrize("module,name,target", [
    ("pandas.io.clipboard", "subprocess.Popen", subprocess.Popen),
    ("pandas._config.localization", "subprocess.Popen", subprocess.Popen),
    ("pandas", "HDFStore", pd.HDFStore),
    ("pandas", "read_pickle", pd.read_pickle)])
def test_export_refuses_dotted_and_unlisted_pandas_globals(
        module, name, target, pkl_dirs):
    """A protocol-4 STACK_GLOBAL follows a dotted name out of pandas (plain
    pickle resolves these to ``target``, then REDUCE would call it); the
    port refuses it, and any pandas global a Series does not need."""
    data = (b"\x80\x04" + _str_op(module) + _str_op(name) + b"\x93"
            + _str_op("true") + b"\x85R.")
    with pytest.raises(_Resolved) as found:
        _Resolver(io.BytesIO(data)).load()
    assert found.value.args[0] is target
    path = os.path.join(str(pkl_dirs / "raw"), PKL)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(pickle.UnpicklingError,
                       match=re.escape(f"refusing {module}.{name}")):
        tgmm.export_gmm_npz("caltech", PERIOD)
    assert not os.path.exists(pkl_dirs / "port" / "gmm" / NPZ)


_DAY0 = pd.Timestamp("2021-05-01")
_SERIES = {
    "int": dict(count=pd.Series(np.arange(DAYS, dtype=np.float64) % 7,
                                index=np.arange(DAYS) * 3)),
    "date": dict(count=pd.Series(
        np.arange(DAYS, dtype=np.float64) % 5,
        index=[(_DAY0 + pd.Timedelta(days=d)).date() for d in range(DAYS)])),
    "datetime": dict(count=pd.Series(
        np.arange(DAYS, dtype=np.float64) % 3,
        index=pd.date_range(_DAY0, periods=DAYS))),
    "object": dict(station_usage=pd.Series(
        np.arange(54, dtype=np.int64) * 2,
        index=pd.Index([f"CA-{i}" for i in range(54)], dtype=object))),
}


@pytest.mark.parametrize("protocol", [2, 5])
@pytest.mark.parametrize("kind", sorted(_SERIES))
def test_export_reads_a_series_of_each_index_kind(kind, protocol, pkl_dirs):
    """``count`` and ``station_usage`` as pandas Series, with the indexes
    a reference pickle may hold, export as the JAX package exports them."""
    _write_pickle(str(pkl_dirs / "raw"), protocol, **_SERIES[kind])
    _equal_npz(tgmm.export_gmm_npz("caltech", PERIOD),
               jgmm.export_gmm_npz("caltech", PERIOD))


def test_load_gmm_fallback_order(pkl_dirs):
    """The committed export, then gmm/ in the port's pack directory (then
    in the committed packs), then a fresh export of the pickle; else an
    error naming every place."""
    committed = pkl_dirs / "port_gmm" / NPZ
    exported = pkl_dirs / "port" / "gmm" / NPZ
    with pytest.raises(FileNotFoundError) as err:
        tgmm.load_gmm("caltech", PERIOD)
    for place in (committed, exported, pkl_dirs / "port_committed" / "gmm"
                  / NPZ, pkl_dirs / "raw" / PKL):
        assert str(place) in str(err.value)

    _write_pickle(str(pkl_dirs / "raw"), pickle.DEFAULT_PROTOCOL)
    fresh = tgmm.load_gmm("caltech", PERIOD)
    assert exported.exists() and fresh["weights"].shape == (3,)

    d = dict(fresh, weights=fresh["weights"] * 0 + 0.5)
    np.savez(exported, **d)
    np.testing.assert_array_equal(tgmm.load_gmm("caltech", PERIOD)["weights"],
                                  0.5)
    committed.parent.mkdir(parents=True)
    np.savez(committed, **dict(d, weights=d["weights"] * 0 + 0.25))
    np.testing.assert_array_equal(tgmm.load_gmm("caltech", PERIOD)["weights"],
                                  0.25)


def test_load_gmm_error_without_a_raw_root(tmp_path, monkeypatch):
    monkeypatch.setattr(tgmm, "GMM_NPZ_DIR", str(tmp_path / "port_gmm"))
    monkeypatch.setattr(tpaths, "PACKED_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(tpaths, "COMMITTED_DIR",
                        str(tmp_path / "port_committed"))
    monkeypatch.setattr(tpaths, "_DEFAULT_RAW_CANDIDATES", ("",))
    with pytest.raises(FileNotFoundError, match="SUSTAINGYM_RAW"):
        tgmm.load_gmm("caltech", PERIOD)


def test_main_on_the_cpu(dirs, capsys):
    out = str(dirs / "fit.npz")
    model = tgmm.main(["--device", "cpu", "--site", "caltech",
                       "--date-period", PERIOD, "--gmm-n", "8", "--out",
                       out])
    lines = capsys.readouterr().out.splitlines()
    count = model["count"]
    assert lines == [
        f"fit 8-component GMM for caltech ({PERIOD}): {DAYS} days, avg "
        f"{count.mean():.1f} sessions/day, log-likelihood "
        f"{model['lower_bound']:.3f}",
        f"saved -> {out}"]
    with np.load(out) as d:
        saved = {k: d[k] for k in d}
    assert sorted(saved) == sorted(tgmm._NPZ_KEYS + ("lower_bound",))
    assert float(saved["lower_bound"]) == model["lower_bound"]
    # 118 of the 123 days have no session: a day draws 0 sessions often
    bank = tgmm.sample_days(saved, 60)
    assert bank["ev_data"].shape == (60, tgmm.MAX_EVS, 4)
    assert bank["ev_station"].shape == bank["ev_mask"].shape \
        == (60, tgmm.MAX_EVS)
    assert bank["ev_mask"].any()
    assert bank["ev_station"].max() < len(STATIONS)


def test_sub_range_fits_its_own_days(dirs, monkeypatch, raw):
    """A custom sub-range keeps the sessions of its own days, where the
    JAX fit_gmm fits the whole four-month file."""
    sub = ("2021-05-31", "2021-06-01")
    X, count, _ = tgmm.session_features("caltech", sub)
    df = _sessions(raw)
    keep = df["day"].astype(str).isin(sub)
    assert count.shape == (2,) and count.sum() == keep.sum() == len(X)
    _, jax_X = jax_fit(monkeypatch, sub)
    assert len(jax_X) == len(df) > len(X)
    full, _, _ = tgmm.session_features("caltech", PERIOD)
    assert jax_X.tobytes() == full.tobytes()


def test_entry_points_default_to_the_card(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgmm.fit_gmm("caltech", PERIOD)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgmm.main(["--site", "caltech", "--date-period", PERIOD])


@pytest.mark.parametrize("block", [True, False])
def test_import_needs_neither_sklearn_nor_jax(block):
    code = ("import sys; "
            + ("sys.modules['sklearn'] = None; " if block else "")
            + "import sustaingym_tpu_torch.data.ev_gmm; "
            "bad = [m for m in sys.modules if m in ('jax', 'sklearn') "
            "and sys.modules[m] is not None or m.startswith(('jax.', "
            "'sklearn.', 'sustaingym_tpu.')) or m == 'sustaingym_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
