"""Live data-refresh clients: SGIP MOER signal + Caltech ACN-Data sessions,
the port of ``sustaingym_tpu.data.api_clients`` (pandas; no JAX).

Ports the reference's data-refresh paths so the raw data can be extended
with new months where network access exists:

- SGIP Signal API (marginal operating emissions rates), mirroring the
  reference's ``sustaingym/data/load_moer.py:61-228``: token auth, paged
  historical/forecast queries (historical <= 31 days, forecast <= 1 day per
  request), merged into the (T, 1 + forecast_steps) monthly layout that
  ``data/ev_etl.build_moer_pack`` compiles, saved as monthly gzip CSVs.
- ACN-Data API (EV charging sessions), mirroring the reference's
  ``sustaingym/envs/evcharging/utils.py:118-180``: token-auth paged
  session fetch for a site/date range with the column normalization that
  ``data/ev_etl.build_trace_pack`` expects.

They run only when called; no env imports them, and ``requests`` is
imported inside the call that needs it, so offline installs are
unaffected. The HTTP layer is injectable (``http=``) for tests with a
fake.
"""
from __future__ import annotations

import datetime as dt
import gzip
import io
import os
from typing import Any, Callable

import numpy as np
import pandas as pd

__all__ = ["get_data_sgip", "save_monthly_moer", "fetch_acn_sessions"]

# SGIP Signal API (public demo credentials published in the reference,
# load_moer.py:36-44; override via env vars for your own account)
SGIP_LOGIN_URL = "https://sgipsignal.com/login/"
SGIP_DATA_URLS = {
    "historical": "https://sgipsignal.com/sgipmoer/",
    "forecasted": "https://sgipsignal.com/sgipforecast/",
}
SGIP_DATA_VERSIONS = {"historical": "1.0", "forecasted": "1.0-1.0.0"}
SGIP_TIME_COLUMN = {"historical": "point_time", "forecasted": "generated_at"}

ACN_API_URL = "https://ev.caltech.edu/api/v1/sessions/{site}"
ACN_PAGE_SIZE = 500


def _http():
    import requests
    return requests


def get_data_sgip(starttime: str, endtime: str, ba: str, req_type: str,
                  forecast_timesteps: int = 36,
                  http: Any = None) -> pd.DataFrame:
    """One SGIP query (historical <= 31 days / forecast <= 1 day).

    Returns a UTC-indexed DataFrame: column ``moer`` (historical) or
    ``f1..f{k}`` (forecast), matching the packaged monthly CSV layout.
    ``http`` is a requests-compatible module/session (injectable for tests).
    """
    http = http or _http()
    user = os.environ.get("SGIP_USERNAME", "sgipmoer")
    password = os.environ.get("SGIP_PASSWORD", "caisotracer")
    login = http.get(SGIP_LOGIN_URL, auth=(user, password)).json()
    if "token" not in login:
        raise RuntimeError(f"SGIP authentication failed: {login!r}")
    params = dict(ba=ba, starttime=starttime, endtime=endtime,
                  version=SGIP_DATA_VERSIONS[req_type])
    r = http.get(SGIP_DATA_URLS[req_type], params=params,
                 headers={"Authorization": f"Bearer {login['token']}"})
    payload = r.json()
    if not isinstance(payload, list) or not payload:
        raise RuntimeError(
            f"SGIP returned no {req_type} data for {ba} "
            f"{starttime}..{endtime}: {payload!r}")
    df = pd.DataFrame(payload)
    df = df.set_index(pd.DatetimeIndex(df[SGIP_TIME_COLUMN[req_type]],
                                       tz="UTC"))
    df.index.name = "time"
    if req_type == "forecasted":
        for i in range(forecast_timesteps):
            df[f"f{i + 1}"] = df["forecast"].map(lambda x: x[i]["value"])
        return df[[f"f{i + 1}" for i in range(forecast_timesteps)]]
    return df[["moer"]]


def save_monthly_moer(year: int, month: int, ba: str, out_dir: str,
                      forecast_timesteps: int = 36,
                      fetch: Callable[..., pd.DataFrame] | None = None
                      ) -> str:
    """Fetches one month of historical + forecast MOER and writes the
    monthly gzip-CSV raw file ``{out_dir}/{ba}_{YYYY-MM}.csv.gz`` that
    ``data/ev_etl.build_moer_pack`` reads from ``<raw root>/moer/``
    (layout of the reference's ``sustaingym/data/load_moer.py:195-228``:
    one row per 5-min mark, columns [moer, f1..f36])."""
    fetch = fetch or get_data_sgip
    first = dt.datetime(year, month, 1, tzinfo=dt.timezone.utc)
    nxt = (dt.datetime(year + 1, 1, 1, tzinfo=dt.timezone.utc) if month == 12
           else dt.datetime(year, month + 1, 1, tzinfo=dt.timezone.utc))
    fmt = "%Y-%m-%dT%H:%M:%S%z"
    hist = fetch(first.strftime(fmt), (nxt - dt.timedelta(minutes=5)
                                       ).strftime(fmt), ba, "historical")
    frames = [hist]
    day = first
    fc_parts = []
    while day < nxt:
        end = min(day + dt.timedelta(days=1) - dt.timedelta(minutes=5),
                  nxt - dt.timedelta(minutes=5))
        fc_parts.append(fetch(day.strftime(fmt), end.strftime(fmt), ba,
                              "forecasted",
                              forecast_timesteps=forecast_timesteps))
        day += dt.timedelta(days=1)
    frames.append(pd.concat(fc_parts))
    df = pd.concat(frames, axis=1).sort_index()

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{ba}_{year}-{month:02d}.csv.gz")
    buf = io.BytesIO()
    with gzip.open(buf, "wt") as f:
        df.to_csv(f)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return path


def fetch_acn_sessions(site: str, start_date: dt.datetime,
                       end_date: dt.datetime, http: Any = None,
                       api_token: str | None = None) -> pd.DataFrame:
    """Paged ACN-Data session fetch for one site/date range.

    Output columns match the packaged session CSVs consumed by
    ``data/ev_etl.build_trace_pack`` (arrival, departure,
    estimated_departure, requested_energy (kWh), delivered_energy (kWh),
    station_id, session_id, claimed) — the reference's
    ``fetch_real_events`` contract (evcharging/utils.py:122-180).
    """
    http = http or _http()
    token = api_token or os.environ.get("ACNDATA_API_TOKEN", "DEMO_TOKEN")
    where = (f'connectionTime>="{start_date:%a, %d %b %Y %H:%M:%S GMT}" and '
             f'connectionTime<="{end_date:%a, %d %b %Y %H:%M:%S GMT}"')
    rows: list[dict] = []
    page = 1
    while True:
        r = http.get(ACN_API_URL.format(site=site),
                     params={"where": where, "page": page,
                             "max_results": ACN_PAGE_SIZE},
                     auth=(token, ""))
        items = r.json().get("_items", [])
        rows.extend(items)
        if len(items) < ACN_PAGE_SIZE:
            break
        page += 1

    def ts(col):
        return pd.to_datetime([row.get(col) for row in rows], utc=True)

    out = pd.DataFrame({
        "arrival": ts("connectionTime"),
        "departure": ts("disconnectTime"),
        "estimated_departure": ts("doneChargingTime"),
        "requested_energy (kWh)": [
            (row.get("userInputs") or [{}])[0].get("kWhRequested", np.nan)
            for row in rows],
        "delivered_energy (kWh)": [row.get("kWhDelivered") for row in rows],
        "station_id": [row.get("spaceID") for row in rows],
        "session_id": [row.get("sessionID") for row in rows],
        "claimed": [bool(row.get("userInputs")) for row in rows],
    })
    return out.sort_values("arrival").reset_index(drop=True)
