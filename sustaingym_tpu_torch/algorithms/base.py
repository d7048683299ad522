"""Algorithm runner harness: the port of ``sustaingym_tpu.algorithms.base``.

Runs an agent over a list of seeds and returns a DataFrame of per-episode
returns and info columns, on two paths:

- ``BaseAlgorithm.run(seeds)``: the classic imperative loop over a
  gymnasium or pettingzoo adapter (``compat/``);
- ``batch_run(env, params, policy_fn, seeds, num_steps)``: every seed
  stepped in lockstep from its seeded reset, one batched step per
  episode step on the params' device. :func:`batch_returns` is the loop
  itself and returns a tensor; ``batch_run`` builds the DataFrame from
  it, so the loop needs no pandas.

pandas is imported where a DataFrame is built, not with this module.
"""
from __future__ import annotations

from collections import defaultdict
from collections.abc import Sequence
from copy import deepcopy
from typing import Any, Callable

import torch

from ..core.rollout import seeded_reset

__all__ = ["BaseAlgorithm", "RandomAlgorithm", "batch_returns", "batch_run",
           "seeded_reset"]


class BaseAlgorithm:
    """Imperative runner over a gymnasium-style env (or a pettingzoo
    adapter with ``multiagent=True``)."""

    def __init__(self, env, multiagent: bool = False):
        self.env = env
        self.multiagent = multiagent

    def get_action(self, observation: Any) -> Any:
        raise NotImplementedError

    def reset(self) -> None:
        """Called at the start of each episode."""

    def run(self, seeds: Sequence[int] | int):
        """One episode a seed; a DataFrame with columns ``seed``,
        ``return`` and the last step's info entries."""
        import pandas as pd
        if isinstance(seeds, int):
            seeds = list(range(seeds))
        results: dict[str, list] = defaultdict(list)
        for seed in seeds:
            results["seed"].append(seed)
            ep_return = 0.0
            obs, _ = self.env.reset(seed=seed)
            self.reset()
            done = False
            info: dict[str, Any] = {}
            while not done:
                action = self.get_action(obs)
                obs, reward, terminated, truncated, info = self.env.step(action)
                if self.multiagent:
                    reward = sum(reward.values())
                    done = any(terminated.values()) or any(truncated.values())
                else:
                    done = terminated or truncated
                ep_return += reward
            results["return"].append(ep_return)
            if self.multiagent and info:
                info = info[next(iter(info))]
            for key, value in info.items():
                results[key].append(deepcopy(value))
        return pd.DataFrame(dict(results))


class RandomAlgorithm(BaseAlgorithm):
    """Uniform-random actions from the env's action space."""

    def get_action(self, observation: Any) -> Any:
        if self.multiagent:
            return {a: self.env.action_spaces[a].sample()
                    for a in self.env.agents}
        return self.env.action_space.sample()


def batch_returns(env, params, policy_fn: Callable, seeds: Sequence[int],
                  num_steps: int, seed_reset_fn: Callable | None = None
                  ) -> torch.Tensor:
    """Each seed's return over ``num_steps`` steps, all seeds stepped in
    lockstep as one batch on ``params``' device: a (len(seeds),) float32
    tensor there.

    ``policy_fn(obs, generator) -> actions`` takes the BATCHED obs (the
    JAX package's takes one env's obs and is vmapped). ``seed_reset_fn(
    params, seeds) -> (state, timestep)`` resets the batch, by default
    with :func:`seeded_reset`. Draws (the policy's and the env's) come from
    one generator seeded with 0 on the params' device, as the JAX package
    draws from ``PRNGKey(0)``."""
    reset = seed_reset_fn or (lambda p, s: seeded_reset(env, p, s))
    state, ts = reset(params, list(seeds))
    generator = torch.Generator(device=params.device).manual_seed(0)
    obs, rewards = ts.obs, []
    for _ in range(num_steps):
        state, ts = env.step(params, state, policy_fn(obs, generator),
                             generator)
        obs = ts.obs
        rewards.append(ts.reward)
    return torch.stack(rewards).sum(0)


def batch_run(env, params, policy_fn: Callable, seeds: Sequence[int],
              num_steps: int, seed_reset_fn: Callable | None = None):
    """:func:`batch_returns` as a DataFrame with columns ``seed`` and
    ``return``."""
    import pandas as pd
    returns = batch_returns(env, params, policy_fn, seeds, num_steps,
                            seed_reset_fn)
    return pd.DataFrame({"seed": list(seeds),
                         "return": returns.cpu().numpy()})
