"""DataCenterEnv: carbon-aware datacenter load shifting, PyTorch + CUDA."""
from __future__ import annotations

from .env import (EPISODE_LEN, DataCenterEnv, DCParams, DCState, make_params,
                  step_core)


def make_env(**kwargs):
    """(env, params); ``kwargs`` go to :func:`make_params` (``device``)."""
    return DataCenterEnv(), make_params(**kwargs)


__all__ = ["DataCenterEnv", "DCParams", "DCState", "EPISODE_LEN",
           "make_params", "make_env", "step_core"]
