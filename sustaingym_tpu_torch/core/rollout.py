"""Batched rollouts: a Python loop over time with the env batch written out.

The port of ``sustaingym_tpu.core.rollout``. A policy is a callback
``policy(policy_params, obs, generator) -> actions`` over batched
observations; every random draw comes from the caller's
``torch.Generator``.
"""
from __future__ import annotations

import inspect
from functools import partial
from typing import Any, Callable

import torch

from .env import FunctionalEnv, TimeStep, autoreset_step
from .graph import Graphs, tree_leaves
from .struct import tree_map, tree_stack

__all__ = ["rollout", "batch_reset", "batch_rollout", "episode_return",
           "random_policy", "episode_loop", "join_episodes", "seeded_reset"]

PolicyFn = Callable[[Any, Any, torch.Generator], Any]


def rollout(env: FunctionalEnv, params, policy: PolicyFn, policy_params,
            generator: torch.Generator, num_steps: int,
            auto_reset: bool = True) -> tuple[Any, TimeStep]:
    """Rolls one env instance forward ``num_steps`` under ``policy``, which
    sees and returns that env's unbatched obs and action. Resets it first.
    Returns (final state, traj): the state and every ``traj`` leaf without
    the env axis, ``traj``'s with a leading time axis of ``num_steps``.
    The env runs as a batch of one, drawing as :func:`batch_rollout` with
    ``batch=1, fast=False`` draws."""
    step = autoreset_step(env) if auto_reset else env.step
    state, ts = env.reset(params, generator, 1)
    obs, traj = ts.obs, []
    for _ in range(num_steps):
        action = torch.as_tensor(policy(
            policy_params, tree_map(lambda x: x[0], obs), generator))[None]
        state, ts = step(params, state, action, generator)
        obs = ts.obs
        traj.append(tree_map(lambda x: x[0], ts))
    return tree_map(lambda x: x[0], state), tree_stack(traj)


def batch_reset(env: FunctionalEnv, params, generator: torch.Generator,
                batch: int):
    """Resets ``batch`` env instances (shared params)."""
    return env.reset(params, generator, batch)


def episode_loop(graphs: Graphs | None, step_loop: partial, *inputs,
                 generator: torch.Generator | None = None,
                 clone: bool = False):
    """The step loop of one episode of a lockstep ``batch_unroll``,
    ``step_loop(*inputs)``: called as it is when ``graphs`` is None, else
    one replay of its graph in ``graphs``, captured at the first call with
    the same function, bound arguments (by identity; the graph holds them)
    and input shapes, drawing from ``generator`` (a bound method among the
    arguments by its object and function). Its slot is the
    function, integer arguments and input shapes: other bound objects (a
    new policy) replace the slot's graph. A replay's outputs are
    rewritten by the next one: ``clone`` copies them out, for a caller
    that replays the graph again before it is done with them."""
    if graphs is None:
        return step_loop(*inputs)
    ints = tuple(a for a in step_loop.args if isinstance(a, int))
    slot = ((step_loop.func,) + ints
            + tuple((x.shape, x.dtype) for x in tree_leaves(inputs)))
    key = slot + tuple(_ident(a) for a in step_loop.args
                       if not isinstance(a, int))
    out = graphs(key, step_loop, *inputs, slot=slot,
                 generators=() if generator is None else (generator,))
    return tree_map(torch.clone, out) if clone else out


def _ident(obj):
    """What names ``obj`` in a capture's key: its ``id``, or for a bound
    method, which is a new object at every attribute access, its object's
    ``id`` and its function."""
    if inspect.ismethod(obj):
        return id(obj.__self__), obj.__func__
    return id(obj)


def join_episodes(parts: list[TimeStep]) -> TimeStep:
    """The episodes' trajectories as one, along the time axis."""
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *xs: torch.cat(xs), *parts)


def batch_rollout(env: FunctionalEnv, params, policy: PolicyFn, policy_params,
                  generator: torch.Generator, batch: int, num_steps: int,
                  auto_reset: bool = True, fast: bool = True,
                  graphs: Graphs | None = None) -> TimeStep:
    """Rolls ``batch`` env instances for ``num_steps`` in lockstep. The
    returned ``TimeStep`` leaves have shape (num_steps, batch, ...).

    Envs with fixed episode lengths may provide a lockstep ``batch_unroll``
    that prefetches each episode's exogenous data once; it is used whenever
    ``fast`` and ``auto_reset`` are set. It calls ``policy`` at every step,
    unless ``graphs`` is given: on a CUDA device each episode's step loop
    is then one replay of a CUDA graph kept in ``graphs``, captured at the
    first call (``policy`` runs at its warm-up and capture only, so it
    must draw from ``generator`` and neither synchronise nor keep Python
    state), and the result holds the graph's outputs until its next
    replay. A graph pays off only when it is replayed: keep ``graphs``
    across calls with the same policy and shapes. Otherwise each step goes
    through ``env.step`` (with :func:`autoreset_step` if ``auto_reset``)."""
    unroll = getattr(env, "batch_unroll", None)
    if fast and auto_reset and unroll is not None:
        return unroll(params, policy, policy_params, batch, num_steps,
                      generator, graphs=graphs)
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


def seeded_reset(env, params, seeds):
    """(state, timestep) of one env a seed, each at its seed's episode:
    the env's ``day_from_seed`` / ``epoch_from_seed`` / ``month_from_seed``
    where it has one, else ``env.reset`` of one env drawn from a
    generator seeded with the seed (the batches joined)."""
    seeds = [int(s) for s in seeds]
    if hasattr(env, "day_from_seed"):
        return env.reset_at_day(
            params, [env.day_from_seed(params, s) for s in seeds])
    if hasattr(env, "epoch_from_seed"):
        return env.reset_at_epoch(
            params, [env.epoch_from_seed(params, s) for s in seeds])
    if hasattr(env, "month_from_seed"):
        return env.reset_at_month(
            params, [env.month_from_seed(params, s) for s in seeds])
    parts = [env.reset(params, torch.Generator(device=params.device)
                       .manual_seed(s), 1) for s in seeds]
    return tree_map(lambda *xs: torch.cat(xs), *parts)
