"""Multi-agent views: a per-agent axis over the single-agent envs.

The port of ``sustaingym_tpu.envs.multiagent``. A view steps the same
underlying state as its base env; its obs carry an agent axis, (B, n_agents,
D), and its rewards one, (B, n_agents). The PettingZoo dict adapters of the
JAX package live at the host edge and are not part of this module.

- :class:`MultiAgentBuildingEnv`: one agent per AC-equipped zone; every
  agent sees the global obs and gets the global reward.
- :class:`MultiAgentCogenEnv`: agents GT1, GT2, GT3 and ST, each owning a
  subset of the 15 action components (a padded (4, 4) layout for a learner
  with one policy per agent); per-agent reward = -(own fuel + ramp + cv
  + non-delivery / 4), ST's fuel being 0.
- :class:`MultiAgentEVChargingEnv`: one agent per station, one action
  each; the flat global obs, with ``periods_delay`` > 0 the other
  stations' est_departures and demands ``periods_delay`` steps stale; the
  global reward / n for each agent; ``discrete_bins`` bins per agent
  mapped to ``a / (bins - 1)``.

Where every agent's obs row is the same, the view returns the global obs
broadcast over the agent axis (``Tensor.expand``, no copy).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..core import (Box, FunctionalEnv, MultiDiscrete, TimeStep, dataclass,
                    flatten, replace)
from ..core.graph import device_const, device_index
from .building.env import BuildingEnv, BuildingParams
from .cogen.env import ACTION_KEYS, CogenEnv, CogenParams
from .evcharging.env import (EVChargingEnv, EVParams, EVState,
                             lockstep_unroll)

__all__ = ["MultiAgentBuildingEnv", "MultiAgentCogenEnv",
           "MultiAgentEVChargingEnv", "MAEVParams", "MAEVState",
           "make_ma_ev_params", "COGEN_AGENTS", "COGEN_AGENT_ACTION_IDX",
           "COGEN_PAD_DIM"]


def _broadcast_agents(x: torch.Tensor, n_agents: int) -> torch.Tensor:
    """(B, ...) -> (B, n_agents, ...), a view."""
    return x[:, None].expand((x.shape[0], n_agents) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# Building
# ---------------------------------------------------------------------------

class MultiAgentBuildingEnv(FunctionalEnv):
    """Agents = the AC-equipped zones. Actions (B, n_agents, 1) in [-1, 1],
    scattered into the n zones (0 elsewhere); obs (B, n_agents, n + 4), the
    global obs; rewards (B, n_agents), the global reward.

    The agent ids are read from ``params.ac_map`` once, on the host, when
    the view is made; the steps index with a kept device tensor."""

    name = "building-multiagent"
    agent_axis = True

    def __init__(self, params: BuildingParams,
                 base: BuildingEnv | None = None):
        self.base = base or BuildingEnv()
        ac = params.ac_map.detach().cpu().numpy()
        self.agents = tuple(int(i) for i in np.nonzero(ac)[0])

    def agent_ids(self, params: BuildingParams | None = None) -> list[int]:
        return list(self.agents)

    def _expand(self, ts: TimeStep) -> TimeStep:
        A = len(self.agents)
        return replace(ts, obs=_broadcast_agents(ts.obs, A),
                       reward=_broadcast_agents(ts.reward, A))

    def reset(self, params: BuildingParams, generator: torch.Generator,
              batch: int):
        state, ts = self.base.reset(params, generator, batch)
        return state, self._expand(ts)

    def reset_at_epoch(self, params: BuildingParams, epoch, **kw):
        state, ts = self.base.reset_at_epoch(params, epoch, **kw)
        return state, self._expand(ts)

    def step(self, params: BuildingParams, state, action,
             generator: torch.Generator | None = None):
        action = torch.as_tensor(action, device=params.device)
        B, A = action.shape[0], len(self.agents)
        full = action.new_zeros((B, params.n)).index_copy_(
            1, device_index(self.agents, params.device),
            action.reshape(B, A))
        state, ts = self.base.step(params, state, full, generator)
        return state, self._expand(ts)

    def observation_space(self, params: BuildingParams):
        return self.base.observation_space(params)

    def action_space(self, params: BuildingParams) -> Box:
        return Box(-1.0, 1.0, (len(self.agents), 1))

    def episode_steps(self, params: BuildingParams) -> int:
        return self.base.episode_steps(params)


# ---------------------------------------------------------------------------
# Cogen
# ---------------------------------------------------------------------------

COGEN_AGENTS = ("GT1", "GT2", "GT3", "ST")
# each agent's indices into the flat 15-component action
COGEN_AGENT_ACTION_IDX = {
    "GT1": (0, 1, 2, 3),
    "GT2": (4, 5, 6, 7),
    "GT3": (8, 9, 10, 11),
    "ST": (12, 13, 14),
}
# the padded per-agent layout of a learner with one policy per agent:
# every agent owns COGEN_PAD_DIM slots; ST's 4th slot is padding
COGEN_PAD_DIM = 4
_COGEN_PAD_MASK = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM), dtype=bool)
_COGEN_FLAT_IDX = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM), dtype=np.int64)
for _a, _agent in enumerate(COGEN_AGENTS):
    for _j, _flat in enumerate(COGEN_AGENT_ACTION_IDX[_agent]):
        _COGEN_PAD_MASK[_a, _j] = True
        _COGEN_FLAT_IDX[_a, _j] = _flat
# the padded layout's real slots, and their components in the flat action
_PAD_VALID = np.nonzero(_COGEN_PAD_MASK.reshape(-1))[0]
_PAD_DEST = _COGEN_FLAT_IDX.reshape(-1)[_PAD_VALID]


class MultiAgentCogenEnv(FunctionalEnv):
    """Agents GT1, GT2, GT3, ST. Actions: the flat (B, 15) action, or the
    padded (B, 4, 4) per-agent layout (:meth:`padded_action_space`, the
    padding ignored); :meth:`assemble_action` builds the flat one from a
    dict of per-agent sub-actions. Obs (B, 4, D), the flat global obs;
    rewards (B, 4), each agent's costs."""

    name = "cogen-multiagent"
    agent_axis = True
    # heterogeneous per-agent action widths (4, 4, 4, 3): a learner stacks
    # one policy per agent and masks the padded slot
    per_agent_policy = True

    def __init__(self, base: CogenEnv | None = None):
        self.base = base or CogenEnv()

    def episode_steps(self, params: CogenParams) -> int:
        return self.base.episode_steps(params)

    def assemble_action(self, agent_actions: dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        """The flat (..., 15) action of per-agent sub-actions (...,
        len(COGEN_AGENT_ACTION_IDX[agent]))."""
        first = next(iter(agent_actions.values()))
        full = first.new_zeros(tuple(first.shape[:-1]) + (len(ACTION_KEYS),))
        for agent, idx in COGEN_AGENT_ACTION_IDX.items():
            full[..., device_index(idx, first.device)] = agent_actions[agent]
        return full

    def _expand(self, params: CogenParams, ts: TimeStep,
                rewards: torch.Tensor) -> TimeStep:
        flat = flatten(self.base.observation_space(params), ts.obs,
                       batch_dims=1)
        return replace(ts, obs=_broadcast_agents(flat, len(COGEN_AGENTS)),
                       reward=rewards)

    def _zero_rewards(self, ts: TimeStep) -> torch.Tensor:
        return ts.reward.new_zeros((ts.reward.shape[0], len(COGEN_AGENTS)))

    def reset(self, params: CogenParams, generator: torch.Generator,
              batch: int):
        state, ts = self.base.reset(params, generator, batch)
        return state, self._expand(params, ts, self._zero_rewards(ts))

    def reset_at_day(self, params: CogenParams, day, generator=None,
                     prev_action=None):
        state, ts = self.base.reset_at_day(params, day, generator,
                                           prev_action)
        return state, self._expand(params, ts, self._zero_rewards(ts))

    def step(self, params: CogenParams, state, action,
             generator: torch.Generator | None = None):
        dev = params.device
        action = torch.as_tensor(action, dtype=torch.float32, device=dev)
        B = action.shape[0]
        if action.shape[1:] == (len(COGEN_AGENTS), COGEN_PAD_DIM):
            # the padded per-agent layout: its real slots into the flat
            # action, the padding dropped
            action = action.new_zeros((B, len(ACTION_KEYS))).index_copy_(
                1, device_index(_PAD_DEST, dev),
                action.reshape(B, -1).index_select(
                    1, device_index(_PAD_VALID, dev)))
        else:
            action = action.reshape(B, len(ACTION_KEYS))
        state, ts = self.base.step(params, state, action, generator)
        info = ts.info
        nd_share = info["non_delivery_cost"] / len(COGEN_AGENTS)
        fuel = torch.cat([info["fuel_costs"],
                          info["fuel_costs"].new_zeros((B, 1))], -1)
        rewards = -(fuel + info["ramp_costs"] + info["dyn_cv_costs"]
                    + nd_share[:, None])
        return state, self._expand(params, ts, rewards)

    def observation_space(self, params: CogenParams):
        return self.base.observation_space(params)

    def action_space(self, params: CogenParams) -> Box:
        return self.base.action_space(params)

    def agent_action_space(self, params: CogenParams, agent: str) -> Box:
        space = self.base.action_space(params)
        idx = list(COGEN_AGENT_ACTION_IDX[agent])
        return Box(space.low[idx], space.high[idx])

    def padded_action_space(self, params: CogenParams) -> Box:
        """(n_agents, COGEN_PAD_DIM) Box of the per-agent learner; the
        padded slots get [0, 1] bounds (masked out of the policy's
        log-prob and entropy, ignored by :meth:`step`)."""
        space = self.base.action_space(params)
        low = np.zeros((len(COGEN_AGENTS), COGEN_PAD_DIM))
        high = np.ones((len(COGEN_AGENTS), COGEN_PAD_DIM))
        low[_COGEN_PAD_MASK] = space.low[_COGEN_FLAT_IDX[_COGEN_PAD_MASK]]
        high[_COGEN_PAD_MASK] = space.high[_COGEN_FLAT_IDX[_COGEN_PAD_MASK]]
        return Box(low, high)

    def action_pad_mask(self) -> np.ndarray:
        """(n_agents, COGEN_PAD_DIM) bool: True where the padded slot is a
        real action component."""
        return _COGEN_PAD_MASK.copy()


# ---------------------------------------------------------------------------
# EV charging
# ---------------------------------------------------------------------------

@dataclass
class MAEVParams:
    base: EVParams
    periods_delay: int = 0
    # > 0: each agent's action is one of ``discrete_bins`` bins, mapped to
    # [0, 1] by a / (bins - 1)
    discrete_bins: int = 0

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def step_table(self) -> torch.Tensor:
        """The base env's (day, t) step table (the EV episode loop reads
        it)."""
        return self.base.step_table


@dataclass
class MAEVState:
    base: EVState
    # staleness ring of past (est_departures, demands), newest last:
    # (B, delay, 2, n), (B, 1, 2, n) when delay = 0
    past_obs: torch.Tensor
    prev_flat: torch.Tensor     # (B, D) the flat current obs

    @property
    def day(self) -> torch.Tensor:
        """The envs' days (the EV episode loop reads them)."""
        return self.base.day


class MultiAgentEVChargingEnv(FunctionalEnv[MAEVParams, MAEVState]):
    """One agent per station. Obs (B, n, D); with ``periods_delay`` > 0 row
    i sees the current est_departures and demands of station i and those
    of ``periods_delay`` steps ago for the others. Actions (B, n, 1) in
    [0, 1], or bins with ``discrete_bins``. Rewards (B, n): the global
    reward / n."""

    name = "evcharging-multiagent"
    agent_axis = True

    def __init__(self, base: EVChargingEnv | None = None):
        self.base = base or EVChargingEnv()

    def episode_steps(self, params: MAEVParams) -> int:
        return self.base.episode_steps(params.base)

    def _flat(self, params: EVParams, obs: dict) -> torch.Tensor:
        """The flat obs, in the obs dict's insertion order."""
        return flatten(self.base.observation_space(params), obs,
                       batch_dims=1)

    def _agent_obs(self, params: MAEVParams, obs: dict,
                   past: torch.Tensor) -> torch.Tensor:
        n = params.base.n_stations
        if params.periods_delay == 0:
            return _broadcast_agents(self._flat(params.base, obs), n)
        eye = device_const(np.eye(n, dtype=bool), params.device, torch.bool)
        # (B, n agents, n stations): own station current, the others stale
        est = torch.where(eye, obs["est_departures"][:, None, :],
                          past[:, 0, 0][:, None, :])
        dem = torch.where(eye, obs["demands"][:, None, :],
                          past[:, 0, 1][:, None, :])
        rows = {k: _broadcast_agents(v, n) for k, v in obs.items()}
        rows["est_departures"], rows["demands"] = est, dem
        return flatten(self.base.observation_space(params.base), rows,
                       batch_dims=2)

    @staticmethod
    def _push(params: MAEVParams, past: torch.Tensor, obs: dict
              ) -> torch.Tensor:
        if params.periods_delay == 0:
            return past
        new = torch.stack([obs["est_departures"], obs["demands"]], 1)
        return torch.cat([past[:, 1:], new[:, None]], 1)

    def reset(self, params: MAEVParams, generator: torch.Generator,
              batch: int):
        base_state, ts = self.base.reset(params.base, generator, batch)
        return self._after_reset(params, base_state, ts)

    def reset_at_day(self, params: MAEVParams, day):
        base_state, ts = self.base.reset_at_day(params.base, day)
        return self._after_reset(params, base_state, ts)

    def _after_reset(self, params: MAEVParams, base_state: EVState,
                     ts: TimeStep):
        n, delay = params.base.n_stations, max(params.periods_delay, 1)
        init = torch.stack([ts.obs["est_departures"], ts.obs["demands"]], 1)
        past = init[:, None].expand(
            (init.shape[0], delay) + tuple(init.shape[1:])).contiguous()
        flat = self._flat(params.base, ts.obs)
        state = MAEVState(base=base_state, past_obs=past, prev_flat=flat)
        return state, replace(ts, obs=self._agent_obs(params, ts.obs, past),
                              reward=flat.new_zeros((flat.shape[0], n)))

    def _base_action(self, params: MAEVParams, action) -> torch.Tensor:
        action = torch.as_tensor(action, device=params.device)
        action = action.reshape(action.shape[0], params.base.n_stations)
        if params.discrete_bins > 0:
            # {0 .. bins-1} -> {0, 1/(bins-1), ..., 1}; a 0-d divisor keeps
            # the IEEE division on the card too
            action = action.to(torch.float32) / device_const(
                float(params.discrete_bins - 1), params.device)
        return action

    def _step_row(self, params: MAEVParams, state: MAEVState, action, row
                  ) -> tuple[MAEVState, TimeStep]:
        """The step given the envs' (day, t) table rows: shared by
        :meth:`step` and :meth:`batch_unroll`'s episode loop. The stale
        rows are read from the ring before the new obs is pushed."""
        base_state, ts = self.base._step_row(
            params.base, state.base, self._base_action(params, action), row)
        obs = self._agent_obs(params, ts.obs, state.past_obs)
        past = self._push(params, state.past_obs, ts.obs)
        flat = self._flat(params.base, ts.obs)
        n = params.base.n_stations
        reward = ts.reward / device_const(float(n), params.device)
        return (MAEVState(base=base_state, past_obs=past, prev_flat=flat),
                replace(ts, obs=obs, reward=_broadcast_agents(reward, n)))

    def step(self, params: MAEVParams, state: MAEVState, action,
             generator: torch.Generator | None = None):
        """One step of every env; ``action`` (B, n, 1) or (B, n)."""
        return self._step_row(
            params, state, action,
            params.base.step_table[state.base.day, state.base.t])

    # ---- uniform-obs fast path ------------------------------------------
    def uniform_agent_obs(self, params: MAEVParams) -> bool:
        """True when every agent's obs row is the same by construction
        (``periods_delay == 0``, continuous actions): a learner with one
        shared policy may then run its trunk once per env (each obs row's
        weight gradient is the sum of its agents')."""
        return params.periods_delay == 0 and params.discrete_bins == 0

    def uniform_ma_unroll(self, params: MAEVParams, policy, policy_params,
                          batch: int, num_steps: int,
                          generator: torch.Generator | None = None,
                          days=None, graphs=None) -> TimeStep:
        """The delay-0 rollout on the base env, no per-agent obs made:
        ``policy`` gets the base env's obs dicts and returns the (B, n)
        base action; returns the base env's trajectory (dict obs, global
        reward)."""
        return self.base.batch_unroll(params.base, policy, policy_params,
                                      batch, num_steps, generator, days,
                                      graphs=graphs)

    # ---- lockstep episode loop ------------------------------------------
    def batch_unroll(self, params: MAEVParams, policy, policy_params,
                     batch: int, num_steps: int,
                     generator: torch.Generator | None = None, days=None,
                     graphs=None) -> TimeStep:
        """The lockstep rollout of the view: the base env's episode loop
        (``envs/evcharging/env.py::lockstep_unroll``, its resets and day
        rows) with the view's ring and per-agent obs in each step, so the
        trajectories equal the generic autoreset loop's on the same
        generator stream, as the base env's do. The reset at an episode
        boundary seeds the ring from the new reset obs."""
        return lockstep_unroll(
            params, partial(self.reset, params),
            partial(self.reset_at_day, params), self._step_row, policy,
            policy_params, batch, num_steps, generator=generator, days=days,
            graphs=graphs)

    def observation_space(self, params: MAEVParams):
        return self.base.observation_space(params.base)

    def action_space(self, params: MAEVParams):
        n = params.base.n_stations
        if params.discrete_bins > 0:
            return MultiDiscrete(np.full((n, 1), params.discrete_bins,
                                         dtype=np.int64))
        return Box(0.0, 1.0, (n, 1))


def make_ma_ev_params(periods_delay: int = 0, discrete_bins: int = 0,
                      **kwargs) -> MAEVParams:
    """The view's params; ``kwargs`` go to the base env's ``make_params``
    (``site``, ``project_action``, ``device``...)."""
    from .evcharging import make_params
    if discrete_bins == 1:
        # a / (bins - 1) would divide by zero: 1 bin is no choice at all
        raise ValueError("discrete_bins must be 0 (continuous) or >= 2")
    return MAEVParams(base=make_params(**kwargs),
                      periods_delay=int(periods_delay),
                      discrete_bins=int(discrete_bins))

