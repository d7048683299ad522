"""CogenEnv: combined-cycle cogeneration dispatch, PyTorch + CUDA."""
from __future__ import annotations

from .env import (ACTION_KEYS, BINARY_IDX, FORECAST_KEYS, CogenEnv,
                  CogenParams, CogenState, make_params, step_core)
from .plant import plant_model


def make_env(**kwargs):
    """(env, params); ``kwargs`` go to :func:`make_params`
    (``renewables_magnitude``, ``forecast_horizon``, ``forecast_noise_std``,
    the penalties, ``device``...)."""
    return CogenEnv(), make_params(**kwargs)


__all__ = [
    "CogenEnv", "CogenParams", "CogenState", "make_params", "make_env",
    "step_core", "plant_model", "ACTION_KEYS", "FORECAST_KEYS", "BINARY_IDX",
]
