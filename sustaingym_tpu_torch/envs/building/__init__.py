"""BuildingEnv: multi-zone thermal RC control, PyTorch + CUDA."""
from __future__ import annotations

import torch

from ...core import resolve_device
from .datadriven import fit_data_driven
from .env import (BuildingEnv, BuildingParams, BuildingState, calc_occupower,
                  kernel_config, make_params)
from .params import (BUILDINGS, GROUND_TEMP, WEATHER, Ufactor, Zone,
                     generate_building_params)
from .stochastic import StochasticAmbientGenerator, generate_stochastic_ambients


def make_env(building: str = "OfficeSmall", weather: str = "Hot_Dry",
             location: str = "Tucson", device="cuda", dtype=torch.float32,
             **kwargs):
    """Compiles the params on the host and returns (env, params) on
    ``device``; ``kwargs`` go to :func:`generate_building_params` (e.g.
    ``root`` and ``u_wall`` for HTM/EPW files of one's own)."""
    device = resolve_device(device)
    p = generate_building_params(building, weather, location, **kwargs)
    return BuildingEnv(), make_params(p, device=device, dtype=dtype)


__all__ = [
    "BuildingEnv", "BuildingParams", "BuildingState", "make_params",
    "make_env", "generate_building_params", "calc_occupower",
    "kernel_config", "fit_data_driven", "BUILDINGS", "GROUND_TEMP",
    "WEATHER", "Ufactor", "Zone",
    "StochasticAmbientGenerator", "generate_stochastic_ambients",
]
