"""GMM-sampled EV sessions: the port of ``sustaingym_tpu.data.ev_gmm``
(the reference's GMMsTraceGenerator and train_gmm_model), with no sklearn.

Sampling: a 30-component, 4-feature Gaussian mixture over (arrival,
departure, estimated departure, requested energy), rejection sampling with
oversampling, empirical per-day session counts and usage-weighted station
assignment, run once on the host into a bank of sampled days in the dense
trace-pack layout of ``data/ev_etl.py``. The sampler replays sklearn's
``GaussianMixture.sample`` call sequence with plain NumPy, so the banks are
bit-equal to the JAX package's. A bank that ``paths.find_pack`` finds
(``evgmm_<site>_<start>_<end>_<n>_<days>_<seed>.npz``: the JAX package
commits some under ``sustaingym_tpu/data/packed/``) is read as it is; any
other bank is sampled at every call (a few ms a day) and written nowhere.

Mixtures (:func:`load_gmm`) come from the JAX package's committed
``sustaingym_tpu/data/gmm/<site>/<start>_<end>_<n>.npz`` exports
(``GMM_NPZ_DIR``, read only), else from ``gmm/`` in the port's pack
directory, else from a fresh :func:`export_gmm_npz` of the reference's
pickle into that directory, read by an unpickler that maps sklearn's
classes to a plain stub.

Fitting (:func:`fit_gmm`, ``python -m sustaingym_tpu_torch.data.ev_gmm``)
is ``GaussianMixture(n, random_state=seed).fit`` on the raw session CSVs:
sklearn's k-means initialisation replayed in NumPy float64 on the host
(:func:`kmeans_labels`), then the full-covariance EM in torch float64 on
the chosen device (:func:`em_fit`). Two divergences from the JAX
``fit_gmm``, by design: ``count`` and ``station_usage`` come in the form of
the committed exports (one float64 count a day of the period, zeros
included; one int32 count a network station in ``station_ids`` order), not
as the JAX package's per-session-day counts and frequency-sorted Series,
which its own sampler misreads; and a custom sub-range fits its own days,
where the JAX function fits the whole four-month file. ``main(["--out",
...])`` writes an ``.npz`` (the five export arrays and ``lower_bound``),
not a pickle of an sklearn object.
"""
from __future__ import annotations

import argparse
import importlib
import math
import os
import pickle

import numpy as np
import torch

from ..core.env import resolve_device
from . import paths
from .ev_etl import (DEFAULT_PERIOD_TO_RANGE, _days_in_range, _load_sessions,
                     _parse_range)

MAX_EVS = 128           # sessions a day (the trace packs' width)
PERIOD_MIN = 5
MINS_IN_DAY = 1440
REQ_ENERGY_SCALE = 100.0
ARRCOL, DEPCOL, ESTCOL, EREQCOL = 0, 1, 2, 3

# the JAX package's committed exports, which the port only reads
GMM_NPZ_DIR = os.path.join(paths._JAX_TREE, "data", "gmm")

_NPZ_KEYS = ("weights", "means", "covariances", "count", "station_usage")
_PACK_KEYS = ("ev_data", "ev_station", "ev_mask")

# sklearn's defaults: KMeans (Lloyd) and GaussianMixture (full covariances)
KMEANS_MAX_ITER, KMEANS_TOL = 300, 1e-4
EM_MAX_ITER, EM_TOL, REG_COVAR = 100, 1e-3, 1e-6


def _gmm_name(site: str, date_period, n_components: int
              ) -> tuple[str, str]:
    """The export's path under its directory and the reference pickle's
    under the raw-data root."""
    start, end = _parse_range(date_period)
    return (os.path.join(site, f"{start}_{end}_{n_components}.npz"),
            os.path.join("evcharging", "gmms", site,
                         f"{start} {end} {n_components}.pkl"))


def load_gmm(site: str, date_period, n_components: int = 30) -> dict:
    """GMM parameters as plain arrays: weights (K,), means (K, 4),
    covariances (K, 4, 4), count (n_days,), station_usage (n_stations,).

    Read from the first of: the committed export under ``GMM_NPZ_DIR``;
    an export under ``gmm/`` that ``paths.find_pack`` finds; a fresh
    :func:`export_gmm_npz` of the reference's pickle under the raw-data
    root (written to ``gmm/`` in the port's pack directory)."""
    name, pkl = _gmm_name(site, date_period, n_components)
    committed = os.path.join(GMM_NPZ_DIR, name)
    try:
        pkl = paths.raw_path(pkl)
    except FileNotFoundError:
        pkl = os.path.join("$SUSTAINGYM_RAW", pkl)
    if os.path.exists(committed):
        path = committed
    elif exported := paths.find_pack("gmm", name):
        path = exported
    elif os.path.exists(pkl):
        path = export_gmm_npz(site, date_period, n_components)
    else:
        raise FileNotFoundError(
            f"GMM {site} {date_period} n={n_components} not found: no "
            f"committed export {committed}, no export "
            f"{' or '.join(paths.pack_places('gmm', name))}, no reference "
            f"pickle {pkl} to export")
    with np.load(path) as d:
        return {k: d[k] for k in _NPZ_KEYS}


class _Estimator:
    """What an sklearn estimator unpickles to: its attribute dict."""

    def __setstate__(self, state: dict):
        self.__dict__.update(state)


# what a reference GMM pickle may name besides sklearn's classes
_SAFE_BUILTINS = frozenset((
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "range", "set", "slice", "str", "tuple"))
_SAFE_GLOBALS = frozenset((
    ("copyreg", "_reconstructor"), ("_codecs", "encode"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("datetime", "date"), ("datetime", "datetime")))
# NumPy's array, scalar and dtype reconstructors under numpy.core (NumPy 1)
# or numpy._core (NumPy 2), by (submodule, name)
_NUMPY_RECONSTRUCTORS = frozenset((
    ("multiarray", "_reconstruct"), ("multiarray", "scalar"),
    ("numeric", "_frombuffer")))
# what a pickled pandas Series with a range, int, float, object or naive
# datetime index (daily frequency included) names, by name, from whichever
# pandas module pandas 1-3 keeps it in; the Int64/UInt64/Float64 indexes
# and the block helpers are pandas 1-2's
_PANDAS_NAMES = frozenset((
    "Series", "SingleBlockManager", "Index", "RangeIndex", "Int64Index",
    "UInt64Index", "Float64Index", "DatetimeIndex", "DatetimeArray", "Day",
    "_new_Index", "_new_DatetimeIndex", "_unpickle_block", "new_block",
    "__pyx_unpickle_NDArrayBacked"))


def _in_package(module: str, package: str) -> bool:
    return module == package or module.startswith(package + ".")


def _numpy_core(sub: str):
    try:
        return importlib.import_module(f"numpy._core.{sub}")
    except ImportError:
        return importlib.import_module(f"numpy.core.{sub}")


class _GmmUnpickler(pickle.Unpickler):
    """Reads a reference GMM pickle without sklearn: sklearn's classes
    become :class:`_Estimator`; NumPy's array, scalar and dtype
    reconstructors, the pandas globals of a Series (``_PANDAS_NAMES``,
    each defined in pandas itself), a few builtin and datetime types and
    ``copyreg._reconstructor`` pass; any other global is refused, and so
    is any dotted name, which protocol 4 would follow into another
    module."""

    def find_class(self, module: str, name: str):
        if "." not in name:
            if _in_package(module, "sklearn"):
                return _Estimator
            if (module in ("builtins", "__builtin__")
                    and name in _SAFE_BUILTINS
                    or (module, name) in _SAFE_GLOBALS):
                return super().find_class(module, name)
            pkg, _, sub = module.rpartition(".")
            if pkg in ("numpy.core", "numpy._core") \
                    and (sub, name) in _NUMPY_RECONSTRUCTORS:
                return getattr(_numpy_core(sub), name)
            if _in_package(module, "pandas") and name in _PANDAS_NAMES:
                obj = super().find_class(module, name)
                if _in_package(getattr(obj, "__module__", None) or "",
                               "pandas"):
                    return obj
        raise pickle.UnpicklingError(
            f"refusing {module}.{name} in a GMM pickle")


def export_gmm_npz(site: str, date_period, n_components: int = 30) -> str:
    """Exports the reference's pickle ``evcharging/gmms/<site>/<start>
    <end> <n>.pkl`` under the raw-data root to
    ``gmm/<site>/<start>_<end>_<n>.npz`` in the port's pack directory
    (``paths.pack_out_path``), with the JAX export's arrays and dtypes. The
    pickle (``{"gmm", "count", "station_usage"}``, the reference's
    save_gmm_model) is read by :class:`_GmmUnpickler`. Returns the path
    written."""
    name, pkl = _gmm_name(site, date_period, n_components)
    with open(paths.raw_path(pkl), "rb") as f:
        d = _GmmUnpickler(f).load()
    gmm = d["gmm"]
    if gmm.covariance_type != "full":
        raise ValueError(f"{pkl}: covariance_type "
                         f"{gmm.covariance_type!r}, not 'full'")
    out = paths.pack_out_path("gmm", name)
    np.savez_compressed(
        out,
        weights=np.asarray(gmm.weights_, dtype=np.float64),
        means=np.asarray(gmm.means_, dtype=np.float64),
        covariances=np.asarray(gmm.covariances_, dtype=np.float64),
        count=np.asarray(d["count"]),
        station_usage=np.asarray(d["station_usage"]))
    return out


def sample_gmm(weights: np.ndarray, means: np.ndarray, covs: np.ndarray,
               n: int, random_state: int) -> np.ndarray:
    """``GaussianMixture.sample(n)[0]`` for full covariances and an int
    ``random_state``: a fresh ``RandomState(random_state)`` draws the
    multinomial component counts, then each component's multivariate
    normals from the same state, stacked in component order."""
    rs = np.random.RandomState(random_state)
    counts = rs.multinomial(n, weights)
    return np.vstack([
        rs.multivariate_normal(mean, cov, int(c))
        for mean, cov, c in zip(means, covs, counts)])


def _sample_sessions(params: dict, n: int, random_state: int,
                     oversample: float = 0.2) -> np.ndarray:
    """Rejection sampling of ``n`` sessions. With an int random_state
    every pass draws the same samples, so an under-filled pass appends
    duplicates before the final cut to ``n`` (the reference does so)."""
    if n == 0:
        return np.empty((0, 4))
    w, mu, cov = params["weights"], params["means"], params["covariances"]
    out: list[np.ndarray] = []
    total = 0
    passes = 0
    while total < n:
        passes += 1
        if passes > 1000:
            raise RuntimeError("GMM rejection sampling made no progress")
        s = sample_gmm(w, mu, cov, int(n * (1 + oversample)), random_state)
        s = s[(0 <= s[:, ARRCOL]) & (s[:, DEPCOL] < 1)
              & (s[:, ESTCOL] < 1) & (s[:, EREQCOL] >= 0)]
        s[:, [ARRCOL, DEPCOL, ESTCOL]] = (
            MINS_IN_DAY * s[:, [ARRCOL, DEPCOL, ESTCOL]] // PERIOD_MIN)
        s = s[(s[:, ARRCOL] < s[:, DEPCOL]) & (s[:, ARRCOL] < s[:, ESTCOL])]
        s[:, EREQCOL] *= REQ_ENERGY_SCALE
        out.append(s)
        total += len(s)
    return np.concatenate(out)[:n]


def _assign_stations(samples: np.ndarray, station_usage: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """Usage-weighted first-available station of each session, in arrival
    order (quicksort on the int arrival slot, as pandas sorts); -1 where
    every station is taken."""
    n_st = len(station_usage)
    probs = station_usage / max(station_usage.sum(), 1)
    order = np.argsort(samples[:, ARRCOL].astype(np.int64), kind="quicksort")
    station_dep = np.full(n_st, -1, dtype=np.int64)
    assigned = np.full(len(samples), -1, dtype=np.int64)
    for i in order:
        arr = samples[i, ARRCOL]
        avail = np.where(station_dep < arr)[0]
        if len(avail) == 0:
            continue
        p_sum = probs[avail].sum()
        if p_sum <= 1e-5:
            idx = rng.choice(avail)
        else:
            idx = rng.choice(avail, p=probs[avail] / p_sum)
        station_dep[idx] = max(samples[i, DEPCOL], station_dep[idx])
        assigned[i] = idx
    return assigned


def build_gmm_trace_pack(site: str, date_period, n_days: int = 200,
                         n_components: int = 30,
                         requested_energy_cap: float = 100.0,
                         seed: int = 0) -> dict[str, np.ndarray]:
    """A bank of ``n_days`` sampled days in the trace-pack layout
    (``ev_data`` (n_days, 128, 4) float32, ``ev_station`` int32,
    ``ev_mask`` bool). Day k depends only on (seed, k). A bank that
    ``paths.find_pack`` finds (the JAX package commits some) is read as it
    is; any other is sampled by :func:`sample_bank`."""
    start, end = _parse_range(date_period)
    path = paths.find_pack(
        f"evgmm_{site}_{start}_{end}_{n_components}_{n_days}_{seed}.npz")
    if path:
        with np.load(path) as d:
            return {k: d[k] for k in _PACK_KEYS}
    return sample_bank(site, date_period, n_days, n_components,
                       requested_energy_cap, seed)


def sample_bank(site: str, date_period, n_days: int, n_components: int = 30,
                requested_energy_cap: float = 100.0, seed: int = 0
                ) -> dict[str, np.ndarray]:
    """Samples the bank of :func:`build_gmm_trace_pack` (committed or
    not)."""
    return sample_days(load_gmm(site, date_period, n_components), n_days,
                       requested_energy_cap, seed)


def sample_days(data: dict, n_days: int, requested_energy_cap: float = 100.0,
                seed: int = 0) -> dict[str, np.ndarray]:
    """A bank of ``n_days`` days sampled from the mixture ``data`` (the
    export's five arrays: :func:`load_gmm`'s or :func:`fit_gmm`'s)."""
    cnt = np.asarray(data["count"])
    usage = np.asarray(data["station_usage"], dtype=np.float64)
    ev_data = np.zeros((n_days, MAX_EVS, 4), dtype=np.float32)
    ev_station = np.zeros((n_days, MAX_EVS), dtype=np.int32)
    ev_mask = np.zeros((n_days, MAX_EVS), dtype=bool)
    for day in range(n_days):
        # the reference generator's stream after reset(seed + day): the
        # day's session count, RandomState(seed + day) GMM draws, then the
        # station choices
        rng = np.random.default_rng(seed=seed + day)
        n = int(rng.choice(cnt))
        samples = _sample_sessions(data, n, int(seed + day))
        st = _assign_stations(samples, usage, rng)
        keep = st >= 0
        samples, st = samples[keep], st[keep]
        k = min(len(samples), MAX_EVS)
        req = np.clip(samples[:k, EREQCOL], 0, requested_energy_cap)
        ev_data[day, :k] = np.stack([samples[:k, ARRCOL], samples[:k, DEPCOL],
                                     samples[:k, ESTCOL], req], axis=1)
        ev_station[day, :k] = st[:k]
        ev_mask[day, :k] = True
    return {"ev_data": ev_data, "ev_station": ev_station, "ev_mask": ev_mask}


# ---- fitting ------------------------------------------------------------

def session_features(site: str, date_period,
                     station_ids: tuple[str, ...] | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The claimed sessions of the period (local arrival date in it) as
    the fit's (N, 4) float64 features: arrival, departure and estimated
    departure as fractions of a day (minute resolution), requested energy
    over 100 kWh. Also ``count``, float64, the claimed sessions of each
    day of the period (zeros included), and ``station_usage``, int32, the
    claimed sessions at each of ``station_ids`` (default: the site's
    network), in that order."""
    if station_ids is None:
        from ..envs.evcharging.sites import load_site
        station_ids = load_site(site).station_ids
    start, end = _parse_range(date_period)
    df = _load_sessions(site, date_period)
    day = df["arrival"].dt.date
    df = df[df["claimed"] & (day >= start) & (day <= end)]
    feats = np.stack([
        (df["arrival"].dt.hour * 60 + df["arrival"].dt.minute) / MINS_IN_DAY,
        (df["departure"].dt.hour * 60 + df["departure"].dt.minute)
        / MINS_IN_DAY,
        (df["estimated_departure"].dt.hour * 60
         + df["estimated_departure"].dt.minute) / MINS_IN_DAY,
        df["requested_energy (kWh)"] / REQ_ENERGY_SCALE,
    ], axis=1)
    per_day = df["arrival"].dt.date.value_counts()
    count = np.array([per_day.get(d, 0) for d in _days_in_range(start, end)],
                     dtype=np.float64)
    per_station = df["station_id"].value_counts()
    usage = np.array([per_station.get(s, 0) for s in station_ids],
                     dtype=np.int32)
    return feats, count, usage


def _sq_distances(Y: np.ndarray, X: np.ndarray, x_sq: np.ndarray
                  ) -> np.ndarray:
    """Squared distances of the rows of ``Y`` to those of ``X`` in
    sklearn's expanded form (``_euclidean_distances``)."""
    d = -2 * (Y @ X.T)
    d += np.einsum("ij,ij->i", Y, Y)[:, None]
    d += x_sq.reshape(1, -1)
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(X: np.ndarray, k: int, x_sq: np.ndarray,
                     rs: np.random.RandomState) -> np.ndarray:
    """sklearn's greedy k-means++ seeding (``_kmeans_plusplus``) on unit
    sample weights: the same draws from ``rs``, the same candidates."""
    n = X.shape[0]
    w = np.ones(n)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rs.choice(n, p=w / w.sum())]
    closest = _sq_distances(centers[0, None], X, x_sq)
    pot = closest @ w
    for c in range(1, k):
        draws = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), draws)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(X[cand], X, x_sq)
        np.minimum(closest, dist, out=dist)
        pots = dist @ w.reshape(-1, 1)
        best = np.argmin(pots)
        pot, closest = pots[best], dist[best]
        centers[c] = X[cand[best]]
    return centers


def _lloyd_step(X: np.ndarray, centers: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Labels of the nearest centers (first on ties) and the new centers,
    as sklearn's ``lloyd_iter_chunked_dense`` on unit weights: an empty
    cluster takes the point farthest from its center, a center is its sum
    times the reciprocal of its weight."""
    k = centers.shape[0]
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2 * (X @ centers.T)
    labels = np.argmin(d, axis=1)
    weight = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.zeros_like(centers)
    np.add.at(sums, labels, X)
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        far_d = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(far_d, -len(empty))[:-len(empty) - 1:-1]
        if far_d.max() > 0:
            for new, i in zip(empty, far):
                sums[labels[i]] -= X[i]
                sums[new] = X[i]
                weight[new] = 1.0
                weight[labels[i]] -= 1.0
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            sums[j] *= 1.0 / weight[j]
        else:
            sums[j] = sums[biggest]
    return labels, sums


def kmeans_labels(X: np.ndarray, n_clusters: int,
                  random_state: np.random.RandomState) -> np.ndarray:
    """The labels of sklearn's ``KMeans(n_clusters, n_init=1,
    random_state=random_state).fit(X)`` (Lloyd), replayed in NumPy
    float64: the data centred on their mean, k-means++ seeding drawing
    from ``random_state`` (nothing draws before it), Lloyd until the
    labels repeat or the centres move less than ``KMEANS_TOL`` times the
    mean feature variance (squared, summed), then a last relabelling."""
    X = np.array(X, dtype=np.float64)
    if X.shape[0] < n_clusters:
        raise ValueError(f"n_samples={X.shape[0]} should be >= "
                         f"n_clusters={n_clusters}.")
    tol = float(np.mean(np.var(X, axis=0)) * KMEANS_TOL)
    X -= X.mean(axis=0)
    centers = _kmeans_plusplus(X, n_clusters, np.einsum("ij,ij->i", X, X),
                               random_state)
    labels_old = None
    for _ in range(KMEANS_MAX_ITER):
        labels, new = _lloyd_step(X, centers)
        shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
        centers = new
        if labels_old is not None and np.array_equal(labels, labels_old):
            return labels
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    return _lloyd_step(X, centers)[0]


def _precision_cholesky(cov: torch.Tensor) -> torch.Tensor:
    """Upper factors of the precisions, ``inv(chol(cov)).T``, batched."""
    L, info = torch.linalg.cholesky_ex(cov)
    if bool((info != 0).any()):
        raise ValueError(
            "GMM fit: a component's covariance is not positive definite "
            "(a singleton or collapsed component); decrease n_components")
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype,
                    device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(L, eye, upper=False).mT


def _m_step(X: torch.Tensor, resp: torch.Tensor):
    """Component masses (+ 10 eps), means and full covariances (+
    ``REG_COVAR`` on the diagonal) of the responsibilities ``resp``."""
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, None]
    diff = X[None] - means[:, None]                        # (K, N, d)
    cov = (resp.T[:, :, None] * diff).mT @ diff / nk[:, None, None]
    cov.diagonal(dim1=-2, dim2=-1).add_(REG_COVAR)
    return nk, means, cov


def _e_step(X: torch.Tensor, weights: torch.Tensor, means: torch.Tensor,
            prec_chol: torch.Tensor):
    """Each point's log-likelihood and log-responsibilities under the
    mixture (``logsumexp`` over the weighted component log-densities)."""
    d = X.shape[1]
    log_det = torch.log(prec_chol.diagonal(dim1=-2, dim2=-1)).sum(-1)
    y = X @ prec_chol - means[:, None] @ prec_chol          # (K, N, d)
    log_prob = -0.5 * (d * math.log(2 * math.pi) + (y * y).sum(-1).T) \
        + log_det
    weighted = log_prob + torch.log(weights)
    norm = torch.logsumexp(weighted, dim=1)
    return norm, weighted - norm[:, None]


def mean_log_likelihood(X: np.ndarray, weights, means, covariances,
                        device="cuda") -> float:
    """The mean log-likelihood of the rows of ``X`` under a full-covariance
    mixture (sklearn's ``GaussianMixture.score``)."""
    dev = resolve_device(device)
    t = [torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
         for a in (X, weights, means, covariances)]
    return float(_e_step(t[0], t[1], t[2], _precision_cholesky(t[3]))[0]
                 .mean())


def em_fit(X: np.ndarray, labels: np.ndarray | None = None, *,
           n_components: int | None = None, weights_init=None,
           means_init=None, precisions_init=None, device="cuda") -> dict:
    """sklearn's full-covariance EM (``GaussianMixture.fit`` after its
    initialisation) in torch float64 on ``device``.

    Starts from the one-hot responsibilities of ``labels`` over
    ``n_components`` (weights the masses over N), or from
    ``weights_init``, ``means_init`` and ``precisions_init`` (full
    precision matrices) as sklearn's ``*_init`` do. Each iteration runs
    the E-step (the lower bound is the mean log-likelihood) and the
    M-step; it stops when the lower bound changes by less than
    ``EM_TOL``, or after ``EM_MAX_ITER``. Returns NumPy float64
    ``weights``, ``means`` and ``covariances``, the last ``lower_bound``, ``n_iter``, ``converged`` and the ``labels``
    of a final E-step."""
    dev = resolve_device(device)
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float64), device=dev)
    if labels is not None:
        resp = torch.nn.functional.one_hot(
            torch.as_tensor(np.asarray(labels), device=dev).long(),
            n_components or -1).double()
        weights, means, cov = _m_step(Xt, resp)
        weights = weights / Xt.shape[0]
        prec_chol = _precision_cholesky(cov)
    else:
        weights, means, prec = (
            torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
            for a in (weights_init, means_init, precisions_init))
        flip = (-2, -1)
        prec_chol = torch.linalg.cholesky(prec.flip(flip)).flip(flip)
    lower_bound, converged = -math.inf, False
    for n_iter in range(1, EM_MAX_ITER + 1):
        prev = lower_bound
        norm, log_resp = _e_step(Xt, weights, means, prec_chol)
        weights, means, cov = _m_step(Xt, log_resp.exp())
        weights = weights / weights.sum()
        prec_chol = _precision_cholesky(cov)
        lower_bound = float(norm.mean())
        if abs(lower_bound - prev) < EM_TOL:
            converged = True
            break
    _, log_resp = _e_step(Xt, weights, means, prec_chol)
    host = {k: v.cpu().numpy() for k, v in (
        ("weights", weights), ("means", means), ("covariances", cov))}
    return {**host, "lower_bound": lower_bound, "n_iter": n_iter,
            "converged": converged,
            "labels": log_resp.argmax(1).cpu().numpy()}


def fit_gmm(site: str, date_period, n_components: int = 30, seed: int = 42,
            *, device="cuda") -> dict:
    """``GaussianMixture(n_components, random_state=seed).fit`` on the
    features of :func:`session_features`: the k-means labels of
    ``RandomState(seed)`` on the host, then :func:`em_fit` on ``device``.
    Returns the export's five arrays in its dtypes (it feeds
    :func:`sample_days` as a committed export does), ``lower_bound``,
    ``n_iter`` and ``converged``."""
    dev = resolve_device(device)
    X, count, usage = session_features(site, date_period)
    labels = kmeans_labels(X, n_components, np.random.RandomState(seed))
    fit = em_fit(X, labels, n_components=n_components, device=dev)
    return {"weights": fit["weights"], "means": fit["means"],
            "covariances": fit["covariances"], "count": count,
            "station_usage": usage, "lower_bound": fit["lower_bound"],
            "n_iter": fit["n_iter"], "converged": fit["converged"]}


def main(argv=None) -> dict:
    """Fits a site's GMM for a period from the raw session CSVs (the
    reference's ``train_gmm_model`` CLI) and prints a summary; ``--out``
    writes the export's five arrays and ``lower_bound`` to an ``.npz``."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--site", default="caltech",
                        choices=["caltech", "jpl"])
    parser.add_argument("--gmm-n", type=int, default=30,
                        help="number of mixture components")
    parser.add_argument("--date-period", default="Summer 2021",
                        help="default period name or 'YYYY-MM-DD YYYY-MM-DD'")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--out", default=None,
                        help="output .npz path (default: print summary only)")
    parser.add_argument("--device", default="cuda",
                        help="device of the EM (default: the card)")
    args = parser.parse_args(argv)
    period = args.date_period
    if period not in DEFAULT_PERIOD_TO_RANGE:
        period = tuple(period.split())
    model = fit_gmm(args.site, period, n_components=args.gmm_n,
                    seed=args.seed, device=args.device)
    count = model["count"]
    print(f"fit {args.gmm_n}-component GMM for {args.site} "
          f"({args.date_period}): {len(count)} days, "
          f"avg {count.mean():.1f} sessions/day, "
          f"log-likelihood {model['lower_bound']:.3f}")
    if args.out:
        np.savez_compressed(args.out, lower_bound=model["lower_bound"],
                            **{k: model[k] for k in _NPZ_KEYS})
        print(f"saved -> {args.out}")
    return model


if __name__ == "__main__":
    main()
