"""SustainGym on PyTorch + CUDA: the EV-charging PPO path of ``sustaingym_tpu``
ported to PyTorch, with its two episode kernels written by hand for Hopper
(``ops/cuda/csrc/ev_rollout.cu``).

The JAX package ``sustaingym_tpu`` is the reference; this package imports
neither it nor JAX. The packed data files are read from
``sustaingym_tpu/data/packed/`` by path (see ``data/paths.py``).

Quick start::

    import torch
    from sustaingym_tpu_torch import make

    env, params = make("evcharging", device="cpu")
    state, ts = env.reset_at_day(params, torch.tensor([0, 1]))
    state, ts = env.step(params, state, torch.full((2, params.n_stations), .5))
"""
from __future__ import annotations

from typing import Any

__version__ = "0.1.0"

_REGISTRY: dict[str, Any] = {}


def register(name: str, factory) -> None:
    """Registers an env factory. ``factory(**kwargs) -> (env, params)``."""
    _REGISTRY[name] = factory


def make(name: str, **kwargs):
    """Creates (env, params) for a registered environment. Registered
    names: 'evcharging' (the other environments are not ported yet)."""
    if not _REGISTRY:
        _populate_registry()
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _populate_registry() -> None:
    from .envs import evcharging
    register("evcharging", evcharging.make_env)
