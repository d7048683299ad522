"""Cogen ambient-conditions ETL -> dense (n_days, 96, 7) pack: the port of
``sustaingym_tpu.data.cogen_etl`` (NumPy and the stdlib; no JAX).

Mirrors the reference pipeline (its ``sustaingym/data/cogen/
load_ambients.py:18-132``): merge ERCOT Houston-hub day-ahead prices
(xlsx), Henry-Hub gas spot prices (csv), plant operating data, and NREL
wind (IEC class-2 power curve scaled by ``renewables_magnitude`` and
subtracted from target power), then split into per-day 96-row (15-min)
frames. Columns: TAMB, PAMB, RHAMB, Target_Power, Target_Steam,
Energy_Price, Gas_Price. The JAX package commits the packs of renewables
magnitudes 0.0 and 100.0; any other magnitude is built from the raw inputs
(``RAW_FILES`` under the raw-data root) and cached in the port's pack
directory (``data/paths.py``).

Data caveat, as in the JAX package: the reference snapshot lacks
``operating_data.xlsx``, so the plant operating table (timestamps, ambient
weather, power and steam targets) is synthesized by
:func:`synthesize_operating_data`, a deterministic, seeded model of
Houston ambient conditions and plant dispatch targets with the schema and
value ranges of the reference docs. Every function here gives the JAX
package's arrays bit for bit on the same raw inputs.
"""
from __future__ import annotations

import csv
import datetime as dt
import os

import numpy as np

from ..utils.xlsx import read_workbook
from .paths import find_pack, pack_out_path, raw_inputs, raw_path

__all__ = ["AMBIENT_COLS", "RAW_FILES", "build_ambients_pack",
           "load_energy_prices", "load_gas_prices",
           "load_wind_capacity_factors", "synthesize_operating_data"]

# the raw inputs, under <raw root>/cogen/ambients_data/
RAW_DIR = os.path.join("cogen", "ambients_data")
WIND_FILE = "0_39.97_-128.77_2019_15min.csv"
ERCOT_FILE = "rpt.00013060.0000000000000000.DAMLZHBSPP_{year}.xlsx"
GAS_FILE = "Henry_Hub_Natural_Gas_Spot_Price.csv"
RAW_FILES = tuple(os.path.join(RAW_DIR, f) for f in (
    WIND_FILE, ERCOT_FILE.format(year=2021), ERCOT_FILE.format(year=2022),
    GAS_FILE))

AMBIENT_COLS = ("Ambient Temperature", "Ambient Pressure",
                "Ambient rel. Humidity", "Target Net Power",
                "Target Process Steam", "Energy Price", "Gas Price")

# IEC Class 2 wind-turbine power curve interpolation points
# (load_ambients.py:23-25)
WIND_CURVE_PTS = np.array(
    [0, 0, 0, 0.0052, 0.0423, 0.1031, 0.1909, 0.3127, 0.4731, 0.6693,
     0.8554, 0.9641, 0.9942, 0.9994, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     0, 0, 0, 0, 0, 0], dtype=np.float64)

# synthesized operating-data span: ~9 months at 15-min resolution
OPERATING_START = dt.date(2021, 5, 1)
OPERATING_END = dt.date(2022, 1, 31)  # inclusive


def load_wind_capacity_factors() -> np.ndarray:
    """15-min wind capacity factors from the NREL wind-speed file."""
    path = raw_path(RAW_DIR, WIND_FILE)
    speeds = []
    with open(path) as f:
        reader = csv.reader(f)
        rows = list(reader)
    header = rows[1]
    col = header.index("wind speed at 100m (m/s)")
    for row in rows[2:]:
        if row and row[col]:
            speeds.append(float(row[col]))
    speeds = np.asarray(speeds)
    return np.interp(speeds, np.arange(32), WIND_CURVE_PTS)


def load_energy_prices() -> dict[dt.datetime, float]:
    """Houston-hub day-ahead hourly prices keyed by hour-beginning local
    time, from the two ERCOT workbooks; DST-odd days dropped
    (load_ambients.py:56-71)."""
    prices: dict[dt.date, dict[int, float]] = {}
    for year in (2021, 2022):
        path = raw_path(RAW_DIR, ERCOT_FILE.format(year=year))
        wb = read_workbook(path)
        for sheet in wb.values():
            for row in sheet[1:]:
                if len(row) < 5 or row[3] != "HB_HOUSTON":
                    continue
                date = dt.datetime.strptime(row[0], "%m/%d/%Y").date()
                hour_beginning = int(str(row[1])[:2]) - 1
                prices.setdefault(date, {})[hour_beginning] = float(row[4])
    out: dict[dt.datetime, float] = {}
    for date, by_hour in prices.items():
        if len(by_hour) != 24:  # daylight-savings days
            continue
        for h, p in by_hour.items():
            out[dt.datetime.combine(date, dt.time(h))] = p
    return out


def load_gas_prices() -> dict[dt.date, float]:
    """Henry-Hub daily spot prices with forward-fill over missing days
    (load_ambients.py:78-88)."""
    path = raw_path(RAW_DIR, GAS_FILE)
    with open(path) as f:
        rows = list(csv.reader(f))
    data: dict[dt.date, float] = {}
    for row in rows[5:]:
        if len(row) >= 2 and row[0] and row[1]:
            day = dt.datetime.strptime(row[0], "%m/%d/%Y").date()
            data[day] = float(row[1])
    days = sorted(data)
    filled: dict[dt.date, float] = {}
    cur = days[0]
    last = data[cur]
    while cur <= days[-1]:
        if cur in data:
            last = data[cur]
        filled[cur] = last
        cur += dt.timedelta(days=1)
    return filled


def synthesize_operating_data(seed: int = 2021) -> tuple[list[dt.datetime], np.ndarray]:
    """Deterministic synthesis of the missing plant operating table.

    Produces 15-min records of (TAMB degF, PAMB psia, RHAMB fraction,
    Target Net Power MW, Target Process Steam klb/h) over the
    OPERATING_START..OPERATING_END span, with Houston-like diurnal/seasonal
    structure and AR(1) weather noise. Value ranges follow the cogen plant
    model bounds (the reference's ``sustaingym/data/cogen/onnx_model/
    model.json`` inputs table and ``sustaingym/envs/cogen/env.py:136-142``).
    """
    rng = np.random.default_rng(seed)
    times: list[dt.datetime] = []
    day = OPERATING_START
    while day <= OPERATING_END:
        for q in range(96):
            times.append(dt.datetime.combine(day, dt.time()) +
                         dt.timedelta(minutes=15 * q))
        day += dt.timedelta(days=1)
    n = len(times)
    t_idx = np.arange(n)
    frac_day = (t_idx % 96) / 96.0
    day_of_year = np.array([t.timetuple().tm_yday for t in times])

    def ar1(sigma, rho=0.995):
        e = rng.normal(scale=sigma * np.sqrt(1 - rho ** 2), size=n)
        out = np.empty(n)
        acc = 0.0
        for i in range(n):
            acc = rho * acc + e[i]
            out[i] = acc
        return out

    seasonal = np.cos(2 * np.pi * (day_of_year - 200) / 365.0)  # peak ~Jul 19
    diurnal = np.cos(2 * np.pi * (frac_day - 0.625))            # peak ~15:00
    tamb = 70.0 + 18.0 * seasonal + 9.0 * diurnal + ar1(4.0)
    tamb = np.clip(tamb, 32.01, 114.99)

    pamb = 14.6 + 0.12 * np.cos(2 * np.pi * day_of_year / 365.0) + ar1(0.08)
    pamb = np.clip(pamb, 14.001, 14.999)

    rh = (0.62 - 0.2 * diurnal - 0.08 * seasonal + ar1(0.06))
    rh = np.clip(rh, 0.02, 0.98)

    # plant dispatch targets: three-GT combined-cycle serving industrial load
    load_shape = (0.78 + 0.16 * np.cos(2 * np.pi * (frac_day - 0.70))
                  + 0.05 * seasonal * np.cos(2 * np.pi * (frac_day - 0.66)))
    power = 560.0 * load_shape + ar1(12.0)
    power = np.clip(power, 120.0, 700.0)

    steam = (980.0 + 120.0 * np.cos(2 * np.pi * (frac_day - 0.45))
             + ar1(25.0))
    steam = np.clip(steam, 300.0, 1300.0)

    return times, np.stack([tamb, pamb, rh, power, steam], axis=1)


def build_ambients_pack(renewables_magnitude: float = 0.0,
                        cache: bool = True) -> np.ndarray:
    """Returns the (n_days, 96, 7) float32 ambient-conditions pack, columns
    in AMBIENT_COLS order: the packed one (the JAX package commits 0.0
    and 100.0) when ``cache`` and ``find_pack`` finds it, else built from
    the raw inputs (``RAW_FILES`` under the raw-data root; without a root
    this raises and names them) and, with ``cache``, written to the
    port's pack directory."""
    renewables_magnitude = float(renewables_magnitude)
    name = f"cogen_ambients_wind={renewables_magnitude}.npz"
    cached = find_pack(name) if cache else None
    if cached:
        return np.load(cached)["ambients"]
    raw_inputs(name, *RAW_FILES)

    times, op = synthesize_operating_data()
    energy = load_energy_prices()
    gas = load_gas_prices()
    wind = load_wind_capacity_factors() * renewables_magnitude

    n = len(times)
    wind = np.resize(wind, n)  # wind file covers 1 year of 15-min data
    rows = np.empty((n, 7), dtype=np.float64)
    valid = np.ones(n, dtype=bool)
    for i, ts in enumerate(times):
        hour_key = ts.replace(minute=0)
        e = energy.get(hour_key)
        g = gas.get(ts.date())
        if e is None or g is None:
            valid[i] = False
            continue
        target_power = max(op[i, 3] - wind[i], 0.0)
        rows[i] = (op[i, 0], op[i, 1], op[i, 2], target_power, op[i, 4], e, g)

    # split into full days of 96 intervals; drop first and last days
    # (load_ambients.py:126-131)
    days: list[np.ndarray] = []
    for start in range(0, n, 96):
        chunk_valid = valid[start:start + 96]
        if chunk_valid.all() and len(chunk_valid) == 96:
            days.append(rows[start:start + 96])
    days = days[1:-1]
    ambients = np.asarray(days, dtype=np.float32)

    if cache:
        np.savez_compressed(pack_out_path(name), ambients=ambients)
    return ambients
