"""Gymnasium adapters: the classic imperative API over the port's batched
step functions.

The port of ``sustaingym_tpu.compat.gym``. A user of the reference keeps
their loop:

    import gymnasium as gym
    import sustaingym_tpu_torch.compat  # registers the IDs
    env = gym.make("sustaingym_torch/EVCharging-v0")       # on the card
    obs, info = env.reset(seed=0)
    obs, r, term, trunc, info = env.step(action)

Each adapter holds its env as a batch of one (the port's envs carry a
leading env axis) on ``device``, the card unless the caller asks for the
CPU, and returns numpy. Random draws come from a ``torch.Generator`` in
place of the JAX key; ``reset(seed=s)`` reseeds it with ``s``. Seeded
resets follow the JAX adapters: building seed -> epoch, cogen / EV /
market seed -> day, datacenter seed -> month.

:class:`FunctionalVectorGymEnv` steps a whole batch on the device with
``core/env.py::autoreset_step`` (``make_vec("evcharging", 4096)``).
"""
from __future__ import annotations

from typing import Any

import gymnasium
import numpy as np
import torch

from ..core import spaces as core_spaces
from ..core.rollout import seeded_reset

__all__ = ["to_gym_space", "FunctionalGymEnv", "BuildingGymEnv",
           "CogenGymEnv", "EVChargingGymEnv", "ElectricityMarketGymEnv",
           "DataCenterGymEnv", "DiscreteActionWrapper",
           "FunctionalVectorGymEnv", "make_vec", "cogen_action_components"]


def to_gym_space(space: core_spaces.Space) -> gymnasium.spaces.Space:
    if isinstance(space, core_spaces.Box):
        return gymnasium.spaces.Box(
            low=space.low.astype(np.float32),
            high=space.high.astype(np.float32), dtype=np.float32)
    if isinstance(space, core_spaces.Discrete):
        return gymnasium.spaces.Discrete(space.n, start=space.start)
    if isinstance(space, core_spaces.MultiDiscrete):
        return gymnasium.spaces.MultiDiscrete(space.nvec)
    if isinstance(space, core_spaces.DictSpace):
        return gymnasium.spaces.Dict(
            {k: to_gym_space(v) for k, v in space.items()})
    raise TypeError(f"unknown space {space}")


def _numpy(tree, index=None):
    """A tensor, or a dict of them, as numpy (row ``index`` of the batch
    when given)."""
    if isinstance(tree, dict):
        return {k: _numpy(v, index) for k, v in tree.items()}
    x = tree if index is None else tree[index]
    return x.detach().cpu().numpy()


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


class FunctionalGymEnv(gymnasium.Env):
    """Wraps (env, params) into a ``gymnasium.Env`` over a batch of one.

    Subclasses set ``breakdown_keys`` (info entries summed over the
    episode into ``info["reward_breakdown"]``, as the reference envs do)
    and may override ``_seeded_reset`` (by default the env's own seed ->
    episode helper, ``core.rollout.seeded_reset``) / ``_convert_action`` /
    ``_convert_obs``."""

    metadata: dict[str, Any] = {}
    breakdown_keys: tuple[str, ...] = ()

    def __init__(self, env, params):
        self.fenv = env
        self.params = params
        self.device = params.device
        self.observation_space = to_gym_space(env.observation_space(params))
        self.action_space = to_gym_space(env.action_space(params))
        self._generator = _generator(self.device, 0)
        self._state = None
        self._breakdown: dict[str, float] = {}

    # -- overridables -----------------------------------------------------
    def _seeded_reset(self, seed: int):
        return seeded_reset(self.fenv, self.params, [seed])

    def _convert_action(self, action) -> torch.Tensor:
        return torch.as_tensor(np.asarray(action), device=self.device)[None]

    def _convert_obs(self, obs):
        return _numpy(obs, 0)

    # -- gymnasium API ----------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        super().reset(seed=seed)
        if seed is None:
            self._state, ts = self.fenv.reset(self.params, self._generator, 1)
        else:
            self._generator = _generator(self.device, seed)
            self._state, ts = self._seeded_reset(seed)
        self._breakdown = {k: 0.0 for k in self.breakdown_keys}
        return self._convert_obs(ts.obs), self._info(ts)

    def step(self, action):
        self._state, ts = self.fenv.step(self.params, self._state,
                                         self._convert_action(action),
                                         self._generator)
        for k in self.breakdown_keys:
            self._breakdown[k] += float(ts.info[k][0])
        return (self._convert_obs(ts.obs), float(ts.reward[0]),
                bool(ts.terminated[0]), bool(ts.truncated[0]),
                self._info(ts))

    def _info(self, ts) -> dict[str, Any]:
        info = _numpy(ts.info, 0)
        if self.breakdown_keys:
            info["reward_breakdown"] = dict(self._breakdown)
        return info


class BuildingGymEnv(FunctionalGymEnv):
    breakdown_keys = ("comfort_level", "power_consumption")

    def __init__(self, building: str = "OfficeSmall", weather: str = "Hot_Dry",
                 location: str = "Tucson", device="cuda", **kwargs):
        from ..envs.building import make_env
        env, params = make_env(building, weather, location, device=device,
                               **kwargs)
        super().__init__(env, params)


def cogen_action_components() -> dict[str, gymnasium.spaces.Space]:
    """The reference's per-component cogen action spaces (its cogen/
    env.py:114-130): a Discrete(2) switch, Discrete(12, start=1) bays or a
    Box of one value, by ``ACTION_KEYS`` name."""
    from ..envs.cogen.env import (ACTION_HIGH, ACTION_KEYS, ACTION_LOW,
                                  BAYS_IDX, BINARY_IDX)
    comps: dict[str, gymnasium.spaces.Space] = {}
    for i, k in enumerate(ACTION_KEYS):
        if i in BINARY_IDX:
            comps[k] = gymnasium.spaces.Discrete(2)
        elif i == BAYS_IDX:
            comps[k] = gymnasium.spaces.Discrete(12, start=1)
        else:
            comps[k] = gymnasium.spaces.Box(
                float(ACTION_LOW[i]), float(ACTION_HIGH[i]), (1,), np.float32)
    return comps


class CogenGymEnv(FunctionalGymEnv):
    """The cogen plant with the reference's Dict action space; the obs's
    ``Prev_Action`` is expanded into the same per-component dict (and the
    observation space says so)."""

    def __init__(self, device="cuda", **kwargs):
        from ..envs.cogen import ACTION_KEYS, make_env
        env, params = make_env(device=device, **kwargs)
        self._keys = ACTION_KEYS
        super().__init__(env, params)
        comps = cogen_action_components()
        self.action_space = gymnasium.spaces.Dict(comps)
        obs_spaces = dict(self.observation_space.spaces)
        obs_spaces["Prev_Action"] = gymnasium.spaces.Dict(comps)
        self.observation_space = gymnasium.spaces.Dict(obs_spaces)

    def _seeded_reset(self, seed: int):
        day = self.fenv.day_from_seed(self.params, seed)
        return self.fenv.reset_at_day(self.params, [day], self._generator)

    def _convert_action(self, action) -> torch.Tensor:
        if isinstance(action, dict):
            action = [float(np.asarray(action[k]).reshape(()))
                      for k in self._keys]
        return torch.as_tensor(np.asarray(action, np.float32),
                               device=self.device)[None]

    def _convert_obs(self, obs):
        out = _numpy(obs, 0)
        pa = out.pop("Prev_Action")
        spaces = self.action_space.spaces
        out["Prev_Action"] = {
            k: (int(round(float(pa[i])))
                if isinstance(spaces[k], gymnasium.spaces.Discrete)
                else np.asarray([pa[i]], np.float32))
            for i, k in enumerate(self._keys)}
        return out


class EVChargingGymEnv(FunctionalGymEnv):
    breakdown_keys = ("profit", "carbon_cost", "excess_charge")

    def __init__(self, site: str = "caltech", date_period: str = "Summer 2021",
                 device="cuda", **kwargs):
        from ..envs.evcharging import make_env
        env, params = make_env(site=site, date_period=date_period,
                               device=device, **kwargs)
        super().__init__(env, params)


class ElectricityMarketGymEnv(FunctionalGymEnv):
    breakdown_keys = ("revenue", "carbon_value", "terminal_cost")

    def __init__(self, device="cuda", **kwargs):
        from ..envs.electricitymarket import make_env
        env, params = make_env(device=device, **kwargs)
        super().__init__(env, params)


class DataCenterGymEnv(FunctionalGymEnv):
    breakdown_keys = ("carbon_cost", "delay_penalty")

    def __init__(self, device="cuda", **kwargs):
        from ..envs.datacenter import make_env
        env, params = make_env(device=device, **kwargs)
        super().__init__(env, params)


class DiscreteActionWrapper(gymnasium.ActionWrapper):
    """Maps Discrete/MultiDiscrete(bins) -> continuous [0, 1] by
    a / (bins - 1), as the reference's wrapper (its envs/wrappers.py)."""

    def __init__(self, env: gymnasium.Env, bins: int = 5):
        if not isinstance(env.action_space, gymnasium.spaces.Box):
            raise ValueError("Should only be used to wrap continuous env")
        super().__init__(env)
        self._bins = bins
        self._cont_dtype = env.action_space.dtype
        dims = env.action_space.shape
        if len(dims) == 0:
            self.action_space = gymnasium.spaces.Discrete(bins)
        else:
            self.action_space = gymnasium.spaces.MultiDiscrete(
                np.ones(dims, dtype=np.int64) * bins)

    def action(self, action):
        return np.asarray(action, dtype=self._cont_dtype) / (self._bins - 1)


class FunctionalVectorGymEnv(gymnasium.vector.VectorEnv):
    """A ``gymnasium.vector.VectorEnv`` of ``num_envs`` envs held as one
    batch on the device and stepped by ``core/env.py::autoreset_step``:
    one batched step a call, however many envs.

    Autoreset is same-step (functional): when an episode ends, the
    returned obs is already the next episode's reset obs, and
    terminated / truncated flag that boundary, as ``autoreset_step`` and
    the JAX adapter do (not gymnasium 1.0's one-step-delayed reset). The
    resets are drawn from the adapter's ``torch.Generator``, seeded by
    ``seed`` or ``reset(seed=...)``."""

    metadata: dict[str, Any] = {}

    def __init__(self, env, params, num_envs: int, seed: int = 0):
        from ..core.env import autoreset_step

        self.fenv = env
        self.params = params
        self.device = params.device
        self.num_envs = int(num_envs)
        self.single_observation_space = to_gym_space(
            env.observation_space(params))
        self.single_action_space = to_gym_space(env.action_space(params))
        self.observation_space = gymnasium.vector.utils.batch_space(
            self.single_observation_space, self.num_envs)
        self.action_space = gymnasium.vector.utils.batch_space(
            self.single_action_space, self.num_envs)
        self._step = autoreset_step(env)
        self._generator = _generator(self.device, seed)
        self._states = None

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._generator = _generator(self.device, seed)
        self._states, ts = self.fenv.reset(self.params, self._generator,
                                           self.num_envs)
        return _numpy(ts.obs), {}

    def step(self, actions):
        actions = torch.as_tensor(np.asarray(actions), device=self.device)
        self._states, ts = self._step(self.params, self._states, actions,
                                      self._generator)
        return (_numpy(ts.obs), _numpy(ts.reward), _numpy(ts.terminated),
                _numpy(ts.truncated), _numpy(ts.info))

    def close(self, **kwargs):
        pass


def make_vec(name: str, num_envs: int, seed: int = 0,
             **kwargs) -> FunctionalVectorGymEnv:
    """``make_vec("evcharging", 4096)`` -> a vectorized gymnasium env on
    the card; ``kwargs`` go to ``sustaingym_tpu_torch.make`` (``device=
    "cpu"`` for the CPU)."""
    from .. import make as _make
    env, params = _make(name, **kwargs)
    return FunctionalVectorGymEnv(env, params, num_envs, seed=seed)
