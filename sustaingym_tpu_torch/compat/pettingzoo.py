"""PettingZoo ParallelEnv adapters over the port's multi-agent views.

The port of ``sustaingym_tpu.compat.pettingzoo``, API-compatible with the
reference's multi-agent envs (PettingZoo >= 1.24): per-agent dict obs,
rewards and terminations, ``agents`` cleared at an episode's end. Each
adapter holds its view as a batch of one on ``device`` (the card unless
the caller asks for the CPU) and returns numpy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from gymnasium import spaces as gym_spaces
from pettingzoo import ParallelEnv

from ..core import flatdim
from ..envs.multiagent import (COGEN_AGENT_ACTION_IDX, COGEN_AGENTS,
                               MultiAgentBuildingEnv, MultiAgentCogenEnv,
                               MultiAgentEVChargingEnv, make_ma_ev_params)
from .gym import _generator, cogen_action_components, to_gym_space

__all__ = ["MultiAgentBuildingParallelEnv", "MultiAgentCogenParallelEnv",
           "MultiAgentEVChargingParallelEnv"]


class _BaseParallelAdapter(ParallelEnv):
    metadata: dict[str, Any] = {}

    def __init__(self, view, params, agents: list):
        self.view = view
        self.params = params
        self.device = params.device
        self.possible_agents = list(agents)
        self.agents = self.possible_agents[:]
        self._generator = _generator(self.device, 0)
        self._state = None

    def _seeded_reset(self, seed: int):
        return self.view.reset(self.params, self._generator, 1)

    def reset(self, seed: int | None = None, options: dict | None = None):
        if seed is None:
            self._state, ts = self.view.reset(self.params, self._generator, 1)
        else:
            self._generator = _generator(self.device, seed)
            self._state, ts = self._seeded_reset(seed)
        self.agents = self.possible_agents[:]
        obs = ts.obs[0].cpu().numpy()
        return ({a: obs[i] for i, a in enumerate(self.agents)},
                {a: {} for a in self.agents})

    def _assemble(self, actions: dict) -> torch.Tensor:
        """(1, n_agents, 1): one value an agent."""
        return torch.as_tensor(np.stack(
            [np.asarray(actions[a], np.float32).reshape(-1)
             for a in self.possible_agents]), device=self.device)[None]

    def step(self, actions: dict):
        self._state, ts = self.view.step(self.params, self._state,
                                         self._assemble(actions),
                                         self._generator)
        obs = ts.obs[0].cpu().numpy()
        reward = ts.reward[0].cpu().numpy()
        term = bool(ts.terminated[0])
        trunc = bool(ts.truncated[0])
        obss, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for i, a in enumerate(self.possible_agents):
            obss[a] = obs[i]
            rewards[a] = float(reward[i])
            terms[a] = term
            truncs[a] = trunc
            infos[a] = {}
        if term or trunc:
            self.agents = []
        return obss, rewards, terms, truncs, infos

    def render(self) -> None:
        pass

    def close(self) -> None:
        pass

    def observation_space(self, agent):
        return self.observation_spaces[agent]

    def action_space(self, agent):
        return self.action_spaces[agent]


class MultiAgentBuildingParallelEnv(_BaseParallelAdapter):
    """Agents = the AC-equipped zone indices."""

    def __init__(self, building: str = "OfficeSmall", weather: str = "Hot_Dry",
                 location: str = "Tucson", device="cuda", **kwargs):
        from ..envs.building import make_env
        base_env, params = make_env(building, weather, location,
                                    device=device, **kwargs)
        view = MultiAgentBuildingEnv(params, base_env)
        super().__init__(view, params, view.agent_ids(params))
        obs_space = to_gym_space(view.observation_space(params))
        self.observation_spaces = {a: obs_space for a in self.possible_agents}
        self.action_spaces = {
            a: gym_spaces.Box(-1.0, 1.0, (1,), np.float32)
            for a in self.possible_agents}

    def _seeded_reset(self, seed: int):
        epoch = self.view.base.epoch_from_seed(self.params, seed)
        return self.view.reset_at_epoch(self.params, [epoch])

    def state(self):
        return self._state.x[0].cpu().numpy()


class MultiAgentCogenParallelEnv(_BaseParallelAdapter):
    """Agents GT1, GT2, GT3 and ST, each with a Dict action of its own
    components of the reference's cogen action space."""

    def __init__(self, device="cuda", **kwargs):
        from ..envs.cogen import ACTION_KEYS, make_env
        base_env, params = make_env(device=device, **kwargs)
        view = MultiAgentCogenEnv(base_env)
        super().__init__(view, params, list(COGEN_AGENTS))
        obs_space = gym_spaces.Box(-np.inf, np.inf,
                                   (flatdim(view.observation_space(params)),),
                                   np.float32)
        self.observation_spaces = {a: obs_space for a in self.possible_agents}
        full = cogen_action_components()
        self.action_spaces = {
            agent: gym_spaces.Dict({ACTION_KEYS[i]: full[ACTION_KEYS[i]]
                                    for i in idx})
            for agent, idx in COGEN_AGENT_ACTION_IDX.items()}
        self._action_keys = ACTION_KEYS

    def _seeded_reset(self, seed: int):
        day = self.view.base.day_from_seed(self.params, seed)
        return self.view.reset_at_day(self.params, [day], self._generator)

    def _assemble(self, actions: dict) -> torch.Tensor:
        """The flat (1, 15) action."""
        flat = np.zeros(len(self._action_keys), np.float32)
        for agent, idx in COGEN_AGENT_ACTION_IDX.items():
            for i in idx:
                flat[i] = float(np.asarray(
                    actions[agent][self._action_keys[i]]).reshape(()))
        return torch.as_tensor(flat, device=self.device)[None]


class MultiAgentEVChargingParallelEnv(_BaseParallelAdapter):
    """Agents = the charging stations' ids. ``periods_delay`` > 0 shows
    each agent the other stations' state that many steps stale;
    ``discrete_bins`` > 0 gives each agent a Discrete(bins) action, mapped
    to bin / (bins - 1) inside the view."""

    def __init__(self, site: str = "caltech", date_period: str = "Summer 2021",
                 periods_delay: int = 0, discrete_bins: int = -1,
                 device="cuda", **kwargs):
        from ..envs.evcharging import load_site
        params = make_ma_ev_params(periods_delay=periods_delay, site=site,
                                   date_period=date_period,
                                   discrete_bins=max(discrete_bins, 0),
                                   device=device, **kwargs)
        view = MultiAgentEVChargingEnv()
        super().__init__(view, params, list(load_site(site).station_ids))
        obs_space = gym_spaces.Box(-np.inf, np.inf,
                                   (flatdim(view.observation_space(params)),),
                                   np.float32)
        self.observation_spaces = {a: obs_space for a in self.possible_agents}
        act = (gym_spaces.Discrete(discrete_bins) if discrete_bins > 0
               else gym_spaces.Box(0.0, 1.0, (1,), np.float32))
        self.action_spaces = {a: act for a in self.possible_agents}

    def _seeded_reset(self, seed: int):
        day = self.view.base.day_from_seed(self.params.base, seed)
        return self.view.reset_at_day(self.params, [day])
