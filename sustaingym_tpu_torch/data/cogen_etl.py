"""Reader for the cogeneration ambient-conditions pack (the cache half of
``sustaingym_tpu.data.cogen_etl.build_ambients_pack``; the ETL that builds
a pack from the raw price, wind and operating-data inputs is not ported).

The pack is (n_days, 96, 7) float32, one row per 15-min interval, columns
TAMB, PAMB, RHAMB, Target_Power, Target_Steam, Energy_Price, Gas_Price.
Packs ship for renewables magnitudes 0.0 and 100.0.
"""
from __future__ import annotations

import os

import numpy as np

from .paths import PACKED_DIR

__all__ = ["build_ambients_pack"]


def build_ambients_pack(renewables_magnitude: float = 0.0) -> np.ndarray:
    """The (n_days, 96, 7) float32 ambient pack for ``renewables_magnitude``
    (the wind capacity subtracted from the power target)."""
    name = f"cogen_ambients_wind={float(renewables_magnitude)}.npz"
    path = os.path.join(PACKED_DIR, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no cogen ambient pack {path}: packs ship for renewables "
            f"magnitudes 0.0 and 100.0 only. Another magnitude needs the "
            f"raw ETL inputs (prices, wind capacity factors), which are "
            f"absent, and the JAX package's data.cogen_etl to build it.")
    return np.load(path)["ambients"]
