"""SustainGym on PyTorch + CUDA: the EV-charging, building, cogeneration,
datacenter and electricity-market paths of ``sustaingym_tpu`` and their
multi-agent views ported to PyTorch, with their TPU kernels written by
hand for Hopper (``ops/cuda/csrc/``): the EV and building episode kernels with and without
the PPO actor inside, the episode slice-gather, the cogen and datacenter
episode kernels and the whole-solve PDHG kernel of the market's SCED
clearing.

The JAX package ``sustaingym_tpu`` is the reference; this package imports
neither it nor JAX. Packed data files are read from the port's own pack
directory ``sustaingym_tpu_torch/data/packed/`` (``SUSTAINGYM_PACKED``
overrides it; the port's ETL writes there), else from the JAX package's
committed ``sustaingym_tpu/data/packed/`` by path, which the port only
reads (see ``data/paths.py``).

Every entry point builds its tensors on the card (``device="cuda"``) unless
the caller asks for the CPU; without a card that default is an error.
Quick start::

    import torch
    from sustaingym_tpu_torch import make

    env, params = make("cogen")                  # on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    roll = env.fused_rollout(params, 4096, 96, generator=gen)

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
    names: 'evcharging', 'building', 'cogen', 'datacenter',
    'electricitymarket', and the multi-agent views 'evcharging-multiagent'
    (``periods_delay``, ``discrete_bins``), 'building-multiagent' and
    'cogen-multiagent' (``envs/multiagent.py``). ``kwargs`` go to the env's
    ``make_env`` (``building`` reads the raw ASHRAE HTM and TMY3 EPW
    tables; see ``envs/building``)."""
    if not _REGISTRY:
        _populate_registry()
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _populate_registry() -> None:
    from .envs import building, cogen, datacenter, electricitymarket, \
        evcharging
    register("evcharging", evcharging.make_env)
    register("building", building.make_env)
    register("cogen", cogen.make_env)
    register("datacenter", datacenter.make_env)
    register("electricitymarket", electricitymarket.make_env)
    from .envs import multiagent as ma

    def _ma_ev(**kw):
        return ma.MultiAgentEVChargingEnv(), ma.make_ma_ev_params(**kw)

    def _ma_building(**kw):
        _, params = building.make_env(**kw)
        return ma.MultiAgentBuildingEnv(params), params

    def _ma_cogen(**kw):
        _, params = cogen.make_env(**kw)
        return ma.MultiAgentCogenEnv(), params

    register("evcharging-multiagent", _ma_ev)
    register("building-multiagent", _ma_building)
    register("cogen-multiagent", _ma_cogen)
