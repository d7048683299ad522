"""EVChargingEnv: ACN charging-network simulation, PyTorch + CUDA."""
from __future__ import annotations

from .env import (EVChargingEnv, EVParams, EVState, battery_charge,
                  make_params, quantize_pilots)
from .sites import SiteSpec, caltech_site, jpl_site, load_site


def make_env(**kwargs):
    """(env, params); ``kwargs`` go to :func:`make_params` (``site``,
    ``date_period``, ``project_action``, ``proj_method``, ``proj_iters``,
    ``trace``, ``gmm_days``, ``device``...)."""
    return EVChargingEnv(), make_params(**kwargs)


__all__ = [
    "EVChargingEnv", "EVParams", "EVState", "make_params", "make_env",
    "quantize_pilots", "battery_charge",
    "SiteSpec", "caltech_site", "jpl_site", "load_site",
]
