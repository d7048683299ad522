"""The training loop of every learner (PPO, A2C, SAC, DQN, DDPG):
``sustaingym_tpu.parallel.runner`` and the JAX package's ``train*``
functions.

Each iteration's metrics are read one step late, so the host's read of
step i overlaps the card's work on step i + 1. With a ``mesh``
(``parallel/mesh.py``) every rank runs the same loop on its shard; the
metrics are all-reduced, so every rank holds the same numbers, and only
rank 0 prints.
"""
from __future__ import annotations

import torch

from .ddpg import DDPGConfig, make_ddpg_train_step
from .dqn import DQNConfig, make_dqn_train_step
from .ppo import PPOConfig, make_train_step
from .sac import SACConfig, make_sac_train_step

__all__ = ["run_train_loop", "train", "train_sac", "train_dqn",
           "train_ddpg"]


def run_train_loop(train_step, carry, generator: torch.Generator,
                   num_iterations: int, verbose: bool = True):
    """Runs ``train_step(carry, generator)`` ``num_iterations`` times;
    returns (final carry, history of float metric dicts). ``verbose``
    prints each iteration's metrics (on rank 0 of a mesh only); the
    trainer's reset guard is read at the end."""
    mesh = getattr(train_step, "mesh", None)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    history = []

    def fetch(i, metrics):
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if verbose:
            print(f"iter {i}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)

    pending = None
    for i in range(num_iterations):
        carry, metrics = train_step(carry, generator)
        if pending is not None:
            fetch(*pending)
        pending = (i, metrics)
    if pending is not None:
        fetch(*pending)
    check = getattr(train_step, "check", None)
    if check is not None:
        check(carry)
    return carry, history


def _train(factory, env, env_params, cfg, generator, num_iterations,
           verbose, mesh):
    init_state, train_step = factory(env, env_params, cfg, mesh=mesh)
    carry = init_state(generator)
    return run_train_loop(train_step, carry, generator, num_iterations,
                          verbose=verbose)


def train(env, env_params, cfg: PPOConfig, generator: torch.Generator,
          num_iterations: int, mesh=None, verbose: bool = True):
    """PPO (or A2C, ``cfg.algo``): the carry made from ``generator``, then
    ``num_iterations`` train steps drawing from it; with ``mesh`` the env
    batch over its dp ranks and the MLP over its mp ranks (every rank
    passes a generator seeded alike)."""
    return _train(make_train_step, env, env_params, cfg, generator,
                  num_iterations, verbose, mesh)


def train_sac(env, env_params, cfg: SACConfig, generator: torch.Generator,
              num_iterations: int, mesh=None, verbose: bool = True):
    """SAC, as :func:`train`."""
    return _train(make_sac_train_step, env, env_params, cfg, generator,
                  num_iterations, verbose, mesh)


def train_dqn(env, env_params, cfg: DQNConfig, generator: torch.Generator,
              num_iterations: int, mesh=None, verbose: bool = True):
    """Double-DQN, as :func:`train`."""
    return _train(make_dqn_train_step, env, env_params, cfg, generator,
                  num_iterations, verbose, mesh)


def train_ddpg(env, env_params, cfg: DDPGConfig, generator: torch.Generator,
               num_iterations: int, mesh=None, verbose: bool = True):
    """DDPG (TD3-style), as :func:`train`."""
    return _train(make_ddpg_train_step, env, env_params, cfg, generator,
                  num_iterations, verbose, mesh)
