"""GMM-sampled EV sessions: the sampling half of ``sustaingym_tpu.data.
ev_gmm`` (the GMMsTraceGenerator analogue), as NumPy.

A 30-component, 4-feature Gaussian mixture over (arrival, departure,
estimated departure, requested energy), rejection sampling with
oversampling, empirical per-day session counts and usage-weighted station
assignment, run once on the host into a bank of sampled days in the dense
trace-pack layout of ``data/ev_etl.py``. The sampler replays sklearn's
``GaussianMixture.sample`` call sequence with plain NumPy, so the banks are
bit-equal to the JAX package's. The mixtures are read from the committed
``sustaingym_tpu/data/gmm/<site>/<start>_<end>_<n>.npz`` exports by path
(fitting and exporting them needs sklearn and the raw tables, and is not
ported).

Banks: a bank committed under ``sustaingym_tpu/data/packed/``
(``evgmm_<site>_<start>_<end>_<n>_<days>_<seed>.npz``) is read as it is;
any other bank is sampled at every call (a few ms a day) and written
nowhere.
"""
from __future__ import annotations

import os

import numpy as np

from .ev_etl import _parse_range
from .paths import PACKED_DIR, _REPO_ROOT

MAX_EVS = 128           # sessions a day (the trace packs' width)
PERIOD_MIN = 5
MINS_IN_DAY = 1440
REQ_ENERGY_SCALE = 100.0
ARRCOL, DEPCOL, ESTCOL, EREQCOL = 0, 1, 2, 3

GMM_NPZ_DIR = os.path.join(_REPO_ROOT, "sustaingym_tpu", "data", "gmm")

_NPZ_KEYS = ("weights", "means", "covariances", "count", "station_usage")
_PACK_KEYS = ("ev_data", "ev_station", "ev_mask")


def load_gmm(site: str, date_period, n_components: int = 30) -> dict:
    """GMM parameters as plain arrays: weights (K,), means (K, 4),
    covariances (K, 4, 4), count (n_days,), station_usage (n_stations,),
    from the committed ``.npz`` export."""
    start, end = _parse_range(date_period)
    path = os.path.join(GMM_NPZ_DIR, site,
                        f"{start}_{end}_{n_components}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"GMM export {path} not found: the port reads the committed "
            f"exports of sustaingym_tpu/data/gmm/ and cannot make them")
    with np.load(path) as d:
        return {k: d[k] for k in _NPZ_KEYS}


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
    ``ev_mask`` bool). Day k depends only on (seed, k). A bank the JAX
    package committed is read as it is; any other is sampled by
    :func:`sample_bank`."""
    start, end = _parse_range(date_period)
    path = os.path.join(
        PACKED_DIR,
        f"evgmm_{site}_{start}_{end}_{n_components}_{n_days}_{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as d:
            return {k: d[k] for k in _PACK_KEYS}
    return sample_bank(site, date_period, n_days, n_components,
                       requested_energy_cap, seed)


def sample_bank(site: str, date_period, n_days: int, n_components: int = 30,
                requested_energy_cap: float = 100.0, seed: int = 0
                ) -> dict[str, np.ndarray]:
    """Samples the bank of :func:`build_gmm_trace_pack` (committed or
    not)."""
    data = load_gmm(site, date_period, n_components)
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
