"""ElectricityMarketEnv: battery bidding into a 5-minute SCED market,
PyTorch + CUDA."""
from __future__ import annotations

from .env import (DISCRETE_BIDS, ElectricityMarketEnv, MarketParams,
                  MarketState, make_params, uses_solve_kernel)
from .network import (BATTERY_CAPACITY_MWH, BATTERY_POWER_MW, GENERATORS,
                      MarketNetwork, build_network, build_sced_matrices)


def make_env(**kwargs):
    """(env, params); ``kwargs`` go to :func:`make_params` (``month``,
    ``horizon``, ``lp_iters``, ``lp_warm_iters``, ``discrete``,
    ``lp_bf16``, ``device``...)."""
    return ElectricityMarketEnv(), make_params(**kwargs)


__all__ = [
    "ElectricityMarketEnv", "MarketParams", "MarketState", "make_params",
    "make_env", "uses_solve_kernel", "build_network", "build_sced_matrices",
    "MarketNetwork", "GENERATORS", "BATTERY_CAPACITY_MWH",
    "BATTERY_POWER_MW", "DISCRETE_BIDS",
]
