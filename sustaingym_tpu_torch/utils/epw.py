"""Minimal EnergyPlus EPW weather-file parser (host-side).

A NumPy copy of ``sustaingym_tpu.utils.epw``. BuildingEnv consumes only the
dry-bulb air temperature and the global horizontal irradiance, parsed from
the standard EPW CSV layout (8 header rows, then 8760 hourly records; dry
bulb = field 6, GHI = field 13, 0-indexed).
"""
from __future__ import annotations

import io

import numpy as np

__all__ = ["read_epw"]

N_HEADER_ROWS = 8
COL_TEMP_AIR = 6   # dry-bulb temperature (deg C)
COL_GHI = 13       # global horizontal irradiance (Wh/m^2)


def read_epw(path_or_file: str | io.TextIOBase) -> dict[str, np.ndarray]:
    """Parses an EPW file.

    Returns:
        dict with keys 'temp_air' (deg C) and 'ghi' (Wh/m^2), each a float64
        array of length n_records (8760 for TMY3 files).
    """
    if isinstance(path_or_file, str):
        with open(path_or_file) as f:
            lines = f.readlines()
    else:
        lines = path_or_file.readlines()

    temp_air: list[float] = []
    ghi: list[float] = []
    for line in lines[N_HEADER_ROWS:]:
        line = line.strip()
        if not line:
            continue
        fields = line.split(",")
        temp_air.append(float(fields[COL_TEMP_AIR]))
        ghi.append(float(fields[COL_GHI]))

    return {
        "temp_air": np.asarray(temp_air, dtype=np.float64),
        "ghi": np.asarray(ghi, dtype=np.float64),
    }
