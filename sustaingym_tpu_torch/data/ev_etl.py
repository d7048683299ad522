"""EV-charging data compilers: MOER day-tables and session trace packs,
the port of ``sustaingym_tpu.data.ev_etl`` (NumPy and pandas; no JAX).

A whole date range is compiled once into dense arrays, cached as ``.npz``
in the port's pack directory (``data/paths.py``); an episode reset is an
index gather. A pack is read from the port's pack directory, else from the
JAX package's committed packs; one found in neither is built from the raw
inputs under the raw-data root (``moer/{ba}_{YYYY-MM}.csv.gz``,
``evcharging/acn_data/{site}/{start} {end}.csv.gz``); without a raw-data
root it raises and names them. On the same raw inputs every pack is the JAX package's bit
for bit.

- MOER pack: (n_days, 289, 37) float32 — historical + 36-step forecasts
  per 5-min row, one slab per LA-local day (the reference's
  ``MOERLoader.retrieve``, ``sustaingym/data/load_moer.py:346-377``).
- Trace pack: per day, up to ``MAX_EVS`` sessions with
  [arrival, departure, est_departure, requested_energy] + station index
  + validity mask (the reference's ``RealTraceGenerator._create_events``,
  ``sustaingym/envs/evcharging/event_generation.py:293-328``).

Divergence from the JAX package: its trace cache key omits
``requested_energy_cap`` (``sustaingym_tpu/data/ev_etl.py:149-153``), so
its cache returns the pack at whatever cap built it. Here the cap is
applied to a cached pack built at a larger cap (exact: a pack holds
``min(requested, cap)``), a larger cap is built from the raw sessions,
and a pack at a cap other than ``PACK_CAP`` is cached under a name that
holds its cap.
"""
from __future__ import annotations

import datetime as dt
import os
from zoneinfo import ZoneInfo

import numpy as np
import pandas as pd

from .paths import find_pack, pack_out_path, raw_inputs, raw_path

LA = ZoneInfo("America/Los_Angeles")
UTC = dt.timezone.utc
PERIOD_MIN = 5
STEPS_PER_DAY = 288
MOER_BA = "SGIP_CAISO_SCE"

# default seasonal ranges (evcharging/utils.py:48-64 of the reference)
DEFAULT_DATE_RANGES = (
    ("2019-05-01", "2019-08-31"),
    ("2019-09-01", "2019-12-31"),
    ("2020-02-01", "2020-05-31"),
    ("2021-05-01", "2021-08-31"),
)
DEFAULT_PERIOD_TO_RANGE = {
    "Summer 2019": DEFAULT_DATE_RANGES[0],
    "Pre-COVID-19 Summer": DEFAULT_DATE_RANGES[0],
    "Fall 2019": DEFAULT_DATE_RANGES[1],
    "Pre-COVID-19 Fall": DEFAULT_DATE_RANGES[1],
    "Spring 2020": DEFAULT_DATE_RANGES[2],
    "In-COVID-19": DEFAULT_DATE_RANGES[2],
    "Summer 2021": DEFAULT_DATE_RANGES[3],
    "Post-COVID-19": DEFAULT_DATE_RANGES[3],
}

MAX_EVS = 128  # max sessions per day (caltech peak observed ~84)
# the requested-energy cap of a trace pack cached under the JAX package's
# file name (its default, and the cap of the shipped packs)
PACK_CAP = 100.0


def _parse_range(date_period) -> tuple[dt.date, dt.date]:
    if isinstance(date_period, str):
        date_period = DEFAULT_PERIOD_TO_RANGE[date_period]
    start = dt.date.fromisoformat(date_period[0])
    end = dt.date.fromisoformat(date_period[1])
    return start, end


def _days_in_range(start: dt.date, end: dt.date) -> list[dt.date]:
    out = []
    d = start
    while d <= end:
        out.append(d)
        d += dt.timedelta(days=1)
    return out


# ---------------------------------------------------------------------------
# MOER
# ---------------------------------------------------------------------------

def moer_files(date_period, ba: str = MOER_BA) -> list[str]:
    """The monthly raw MOER files (relative to the raw-data root) that
    cover ``date_period``."""
    start, end = _parse_range(date_period)
    files = []
    cur = dt.date(start.year, start.month, 1)
    end_month = dt.date(end.year, end.month, 1)
    while cur <= end_month:
        files.append(os.path.join(
            "moer", f"{ba}_{cur.year}-{cur.month:02d}.csv.gz"))
        cur = (dt.date(cur.year + 1, 1, 1) if cur.month == 12
               else dt.date(cur.year, cur.month + 1, 1))
    return files


def build_moer_pack(date_period, ba: str = MOER_BA, cache: bool = True
                    ) -> np.ndarray:
    """(n_days, 289, 37) float32 MOER pack of balancing authority ``ba``
    for all days in the range: the cached pack, else built from the
    monthly raw CSVs (``moer_files``) and, with ``cache``, written to
    the port's pack directory."""
    start, end = _parse_range(date_period)
    name = f"moer_{ba}_{start}_{end}.npz"
    cached = find_pack(name) if cache else None
    if cached:
        return np.load(cached)["moer"]

    # load all months overlapping [start, end + 1 day]
    frames = []
    for path in raw_inputs(name, *moer_files(date_period, ba)):
        df = pd.read_csv(path, compression="gzip", index_col="time")
        df.index = pd.to_datetime(df.index, utc=True)
        frames.append(df)
    df = pd.concat(frames)
    df = df[~df.index.duplicated(keep="first")].sort_index()

    days = _days_in_range(start, end)
    n_rows = STEPS_PER_DAY + 1
    out = np.zeros((len(days), n_rows, df.shape[1]), dtype=np.float32)
    values = df.to_numpy(dtype=np.float32)
    index = df.index
    for i, day in enumerate(days):
        t0 = dt.datetime.combine(day, dt.time(), tzinfo=LA).astimezone(UTC)
        t1 = t0 + dt.timedelta(days=1, minutes=PERIOD_MIN)
        lo = index.searchsorted(t0, side="left")
        hi = index.searchsorted(t1, side="left")
        rows = values[lo:hi]
        out[i, :len(rows)] = rows[:n_rows]
    if cache:
        np.savez_compressed(pack_out_path(name), moer=out)
    return out


# ---------------------------------------------------------------------------
# Real session traces
# ---------------------------------------------------------------------------

def sessions_file(site: str, date_period) -> str:
    """The raw ACN session file (relative to the raw-data root) of the
    default range that covers ``date_period``."""
    start, end = _parse_range(date_period)
    for rng in DEFAULT_DATE_RANGES:
        if (dt.date.fromisoformat(rng[0]) <= start
                and end <= dt.date.fromisoformat(rng[1])):
            return os.path.join("evcharging", "acn_data", site,
                                f"{rng[0]} {rng[1]}.csv.gz")
    raise FileNotFoundError(
        f"no packaged ACN data covers {date_period} for {site}")


def _load_sessions(site: str, date_period) -> pd.DataFrame:
    df = pd.read_csv(raw_path(sessions_file(site, date_period)),
                     compression="gzip")
    for col in ("arrival", "departure", "estimated_departure"):
        df[col] = pd.to_datetime(df[col], utc=True).dt.tz_convert(
            "America/Los_Angeles")
    return df


def trace_pack_name(site: str, date_period, use_unclaimed: bool = False,
                    requested_energy_cap: float = PACK_CAP) -> str:
    """The cache file name of a trace pack: the JAX package's at
    ``PACK_CAP``, with the cap added at any other."""
    start, end = _parse_range(date_period)
    cap = float(requested_energy_cap)
    suffix = "" if cap == PACK_CAP else f"_cap={cap}"
    return f"evtrace_{site}_{start}_{end}_{int(use_unclaimed)}{suffix}.npz"


def _load_trace(path: str) -> dict[str, np.ndarray]:
    d = np.load(path)
    return {k: d[k] for k in ("ev_data", "ev_station", "ev_mask")}


def build_trace_pack(site: str, date_period, station_ids: tuple[str, ...],
                     requested_energy_cap: float = PACK_CAP,
                     use_unclaimed: bool = False, cache: bool = True
                     ) -> dict[str, np.ndarray]:
    """Compiles real traces into dense day tables.

    Returns dict of arrays:
        ev_data: (n_days, MAX_EVS, 4) float32
                 [arrival, departure, est_departure, requested_energy]
        ev_station: (n_days, MAX_EVS) int32 station index
        ev_mask: (n_days, MAX_EVS) bool
    Filtering mirrors RealTraceGenerator._create_events
    (event_generation.py:293-328): claimed-only, station in network,
    same-(calendar)-day departures, est_departure > arrival; requested
    energy capped at ``requested_energy_cap``.

    With ``cache``: the pack cached at this cap, else the pack cached at
    ``PACK_CAP`` with the cap applied when the cap is at most
    ``PACK_CAP``, else built from the raw sessions and written under
    :func:`trace_pack_name` to the port's pack directory. Each cached pack
    is looked for by ``find_pack``.
    """
    cap = float(requested_energy_cap)
    name = trace_pack_name(site, date_period, use_unclaimed, cap)
    cached = find_pack(name) if cache else None
    if cached:
        return _load_trace(cached)
    wide = (find_pack(trace_pack_name(site, date_period, use_unclaimed))
            if cache and cap <= PACK_CAP else None)
    if wide:
        pack = _load_trace(wide)
        pack["ev_data"][..., 3] = np.minimum(pack["ev_data"][..., 3],
                                             np.float32(cap))
        return pack

    raw_inputs(name, sessions_file(site, date_period))
    df = _load_sessions(site, date_period)
    if not use_unclaimed:
        df = df[df["claimed"]]
    sid_to_idx = {s: i for i, s in enumerate(station_ids)}
    df = df[df["station_id"].isin(sid_to_idx)]

    start, end = _parse_range(date_period)
    days = _days_in_range(start, end)
    n_days = len(days)
    ev_data = np.zeros((n_days, MAX_EVS, 4), dtype=np.float32)
    ev_station = np.zeros((n_days, MAX_EVS), dtype=np.int32)
    ev_mask = np.zeros((n_days, MAX_EVS), dtype=bool)

    arr = df["arrival"]
    for i, day in enumerate(days):
        day_mask = np.array([a.date() == day for a in arr])
        sub = df[day_mask]
        if len(sub) == 0:
            continue
        # same-calendar-day departure filter: reference compares
        # day-of-month only (event_generation.py:314-315)
        max_dep = np.maximum(sub["departure"], sub["estimated_departure"])
        sub = sub[[m.day == day.day for m in max_dep]]
        if len(sub) == 0:
            continue
        k = 0
        for _, row in sub.iterrows():
            a = (row["arrival"].hour * 60 + row["arrival"].minute) // PERIOD_MIN
            d = (row["departure"].hour * 60 + row["departure"].minute) // PERIOD_MIN
            e = (row["estimated_departure"].hour * 60
                 + row["estimated_departure"].minute) // PERIOD_MIN
            if e <= a:
                continue
            if k >= MAX_EVS:
                break
            req = min(float(row["requested_energy (kWh)"]), cap)
            ev_data[i, k] = (a, d, e, req)
            ev_station[i, k] = sid_to_idx[row["station_id"]]
            ev_mask[i, k] = True
            k += 1

    pack = {"ev_data": ev_data, "ev_station": ev_station, "ev_mask": ev_mask}
    if cache:
        np.savez_compressed(pack_out_path(name), **pack)
    return pack
