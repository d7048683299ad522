"""Batched rollouts: a Python loop over time with the env batch written out.

The port of ``sustaingym_tpu.core.rollout``. A policy is a callback
``policy(policy_params, obs, generator) -> actions`` over batched
observations; every random draw comes from the caller's
``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .env import FunctionalEnv, TimeStep, autoreset_step
from .struct import tree_stack

__all__ = ["batch_reset", "batch_rollout", "episode_return",
           "random_policy"]

PolicyFn = Callable[[Any, Any, torch.Generator], Any]


def batch_reset(env: FunctionalEnv, params, generator: torch.Generator,
                batch: int):
    """Resets ``batch`` env instances (shared params)."""
    return env.reset(params, generator, batch)


def batch_rollout(env: FunctionalEnv, params, policy: PolicyFn, policy_params,
                  generator: torch.Generator, batch: int, num_steps: int,
                  auto_reset: bool = True, fast: bool = True) -> TimeStep:
    """Rolls ``batch`` env instances for ``num_steps`` in lockstep. The
    returned ``TimeStep`` leaves have shape (num_steps, batch, ...).

    Envs with fixed episode lengths may provide a lockstep ``batch_unroll``
    that prefetches each episode's exogenous data once; it is used whenever
    ``fast`` and ``auto_reset`` are set. Otherwise each step goes through
    ``env.step`` (with :func:`autoreset_step` if ``auto_reset``)."""
    unroll = getattr(env, "batch_unroll", None)
    if fast and auto_reset and unroll is not None:
        return unroll(params, policy, policy_params, batch, num_steps,
                      generator)
    step = autoreset_step(env) if auto_reset else env.step
    states, ts = batch_reset(env, params, generator, batch)
    obs, traj = ts.obs, []
    for _ in range(num_steps):
        actions = policy(policy_params, obs, generator)
        states, ts = step(params, states, actions, generator)
        obs = ts.obs
        traj.append(ts)
    return tree_stack(traj)


def episode_return(traj: TimeStep) -> torch.Tensor:
    """Sums rewards over the time axis (axis 0)."""
    return torch.sum(traj.reward, 0)


def random_policy(env: FunctionalEnv, params, batch: int | None = None
                  ) -> PolicyFn:
    """Uniform-random policy over the env's Box action space, drawn from
    the generator. With ``batch`` set it returns (batch, ...) actions."""
    space = env.action_space(params)

    def policy(_, obs, generator):
        if batch is None:
            return space.sample(generator)
        return space.sample_batch(generator, batch)

    return policy
