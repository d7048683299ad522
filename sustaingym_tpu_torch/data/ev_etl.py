"""Readers for the EV-charging data packs (the cache half of
``sustaingym_tpu.data.ev_etl``; the raw-CSV ETL is not ported).

- MOER pack: (n_days, 289, 37) float32 — historical + 36-step forecasts
  per 5-min row, one slab per LA-local day.
- Trace pack: per day, up to 128 sessions
  [arrival, departure, est_departure, requested_energy] + station index
  + validity mask.
"""
from __future__ import annotations

import datetime as dt

import numpy as np

from .paths import packed_path

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


def _parse_range(date_period) -> tuple[dt.date, dt.date]:
    if isinstance(date_period, str):
        date_period = DEFAULT_PERIOD_TO_RANGE[date_period]
    start = dt.date.fromisoformat(date_period[0])
    end = dt.date.fromisoformat(date_period[1])
    return start, end


def build_moer_pack(date_period, ba: str = MOER_BA) -> np.ndarray:
    """(n_days, 289, 37) float32 MOER pack of balancing authority ``ba``
    for all days in the range."""
    start, end = _parse_range(date_period)
    return np.load(packed_path(f"moer_{ba}_{start}_{end}.npz"))["moer"]


def build_trace_pack(site: str, date_period) -> dict[str, np.ndarray]:
    """Dense day tables of real (claimed) sessions: ``ev_data``
    (n_days, 128, 4) float32, ``ev_station`` (n_days, 128) int32,
    ``ev_mask`` (n_days, 128) bool."""
    start, end = _parse_range(date_period)
    # the trailing 0: claimed sessions only (the JAX ETL's default)
    d = np.load(packed_path(f"evtrace_{site}_{start}_{end}_0.npz"))
    return {k: d[k] for k in ("ev_data", "ev_station", "ev_mask")}
