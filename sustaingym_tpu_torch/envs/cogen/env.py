"""CogenEnv in PyTorch — combined-cycle cogeneration dispatch.

The port of ``sustaingym_tpu.envs.cogen.env``, with the batch axis written
out (every state tensor is (B, ...)). A day has 96 steps of 15 minutes. The
flat action has 15 components (three gas turbines' power, power-
augmentation and evaporative-cooler switches and HRSG steam, steam-turbine
power, IP process steam, cooling-tower bays); the observation is the time,
the previous action and 7 forecast channels over ``forecast_horizon + 1``
rows; the reward is -(fuel + ramp + non-delivery + dynamic constraint
violations) of the plant surrogate in ``plant.py``.

``step_core`` is the one formula of a step: ``CogenEnv.step``,
``CogenEnv.batch_unroll`` and the plain version of the episode kernel
(``ops/cuda/cogen_rollout.py``) all call it. Whole days run through the
CUDA kernels of ``ops/cuda`` in :meth:`CogenEnv.batch_unroll` (the
per-episode ambient gather) and :meth:`CogenEnv.fused_rollout` (the gather
and the episode kernel). Random draws come from a ``torch.Generator``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ...core import (Box, DictSpace, FunctionalEnv, TimeStep, dataclass,
                     draw_env_rows, kernel_seed, resolve_device, tree_map,
                     tree_stack)
from ...core.graph import device_const, device_index
from ...core.rollout import episode_loop, join_episodes
from . import plant

# Flat action layout, in the reference Dict's insertion order.
ACTION_KEYS = (
    "GT1_PWR", "GT1_PAC_FFU", "GT1_EVC_FFU", "HR1_HPIP_M_PROC",
    "GT2_PWR", "GT2_PAC_FFU", "GT2_EVC_FFU", "HR2_HPIP_M_PROC",
    "GT3_PWR", "GT3_PAC_FFU", "GT3_EVC_FFU", "HR3_HPIP_M_PROC",
    "ST_PWR", "IPPROC_M", "CT_NrBays")

ACTION_LOW = np.array([
    plant.GT_PWR_LO[0], 0, 0, plant.HR_LO[0],
    plant.GT_PWR_LO[1], 0, 0, plant.HR_LO[1],
    plant.GT_PWR_LO[2], 0, 0, plant.HR_LO[2],
    plant.ST_LO, plant.IP_LO, 1], dtype=np.float64)
ACTION_HIGH = np.array([
    plant.GT_PWR_HI[0], 1, 1, plant.HR_HI[0],
    plant.GT_PWR_HI[1], 1, 1, plant.HR_HI[1],
    plant.GT_PWR_HI[2], 1, 1, plant.HR_HI[2],
    plant.ST_HI, plant.IP_HI, 12], dtype=np.float64)

# indices of the discrete components within the flat action
BINARY_IDX = (1, 2, 5, 6, 9, 10)
BAYS_IDX = 14
PWR_IDX = (0, 4, 8, 12)  # GT1, GT2, GT3, ST — ramp-cost components

# forecast channel order
FORECAST_KEYS = ("TAMB", "PAMB", "RHAMB", "Target_Power", "Target_Steam",
                 "Energy_Price", "Gas_Price")

# plant-model input order of the action components (model.json)
_MODEL_INPUT_ACTION = [1, 2, 0, 5, 6, 4, 9, 10, 8, 3, 7, 11, 12, 13, 14]


@dataclass
class CogenParams:
    # (n_days, 96 + horizon + 1, 7): each day padded with the head of the
    # next day so forecasts never cross an array boundary
    ambients: torch.Tensor
    ramp_penalty: float
    supply_imbalance_penalty: float
    constraint_violation_penalty: float
    forecast_noise_std: float
    n_days: int
    timesteps_per_day: int = 96
    forecast_horizon: int = 3

    @property
    def device(self) -> torch.device:
        return self.ambients.device


@dataclass
class CogenState:
    day: torch.Tensor          # (B,) int64
    t: torch.Tensor            # (B,) int64
    prev_action: torch.Tensor  # (B, 15) float32
    # the episode's channel-major ambient day slab (B, 7, 96 + h + 1),
    # rolled one column left per step so column 0 is the current time
    slab: torch.Tensor


def make_params(renewables_magnitude: float = 0.0,
                ramp_penalty: float = 2.0,
                supply_imbalance_penalty: float = 1000.0,
                constraint_violation_penalty: float = 1000.0,
                forecast_horizon: int = 3,
                forecast_noise_std: float = 0.0,
                device="cuda") -> CogenParams:
    """Reads the packed ambient days and pads each with the head of the
    next day (wrapping), on ``device`` (the card unless the caller asks for
    the CPU)."""
    from ...data.cogen_etl import build_ambients_pack
    device = resolve_device(device)
    amb = build_ambients_pack(renewables_magnitude)  # (n_days, 96, 7)
    n_days, steps, _ = amb.shape
    if not 0 <= forecast_horizon < steps - 1:
        raise ValueError(f"forecast_horizon must be in [0, {steps - 2}]")
    pad = np.roll(amb, -1, axis=0)[:, :forecast_horizon + 1, :]
    amb_padded = np.concatenate([amb, pad], axis=1)
    return CogenParams(
        ambients=torch.as_tensor(amb_padded, dtype=torch.float32,
                                 device=device).contiguous(),
        ramp_penalty=float(ramp_penalty),
        supply_imbalance_penalty=float(supply_imbalance_penalty),
        constraint_violation_penalty=float(constraint_violation_penalty),
        forecast_noise_std=float(forecast_noise_std),
        n_days=int(n_days), timesteps_per_day=int(steps),
        forecast_horizon=int(forecast_horizon))


def pack_model_input(ambient_row: torch.Tensor, action: torch.Tensor
                     ) -> torch.Tensor:
    """The 18-wide plant-model input from the true ambient rows (..., 7)
    and the flat actions (..., 15)."""
    return torch.cat([ambient_row[..., :3],
                      action[..., device_index(_MODEL_INPUT_ACTION,
                                               action.device)]],
                     -1)


def dyn_constraint_violation(x: torch.Tensor, y: torch.Tensor
                             ) -> torch.Tensor:
    """(..., 16) dynamic operating-constraint violations, in groups of four
    for GT1, GT2, GT3 and the steam turbine."""
    r = torch.relu
    cols = [
        (y[..., 9], x[..., 5]), (x[..., 5], y[..., 10]),     # GT1 power
        (y[..., 15], x[..., 12]), (x[..., 12], y[..., 16]),  # GT1 steam
        (y[..., 11], x[..., 8]), (x[..., 8], y[..., 12]),    # GT2 power
        (y[..., 17], x[..., 13]), (x[..., 13], y[..., 18]),  # GT2 steam
        (y[..., 13], x[..., 11]), (x[..., 11], y[..., 14]),  # GT3 power
        (y[..., 19], x[..., 14]), (x[..., 14], y[..., 20]),  # GT3 steam
        (y[..., 24], x[..., 15]), (x[..., 15], y[..., 25]),  # ST power
        (x[..., 16], y[..., 22]), (x[..., 16], y[..., 23]),  # IP letdown
    ]
    return torch.stack([r(a - b) for a, b in cols], -1)


def step_core(params: CogenParams, prev_action: torch.Tensor,
              action: torch.Tensor, ambient_now: torch.Tensor
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Plant dispatch and reward of one step for a batch: actions (B, 15)
    against the step's true ambient rows (B, 7). Returns (reward (B,),
    info)."""
    x = pack_model_input(ambient_now, action)
    y = plant.plant_model(x)
    pwr = device_index(PWR_IDX, action.device)
    ramp = params.ramp_penalty * torch.abs(action[..., pwr]
                                           - prev_action[..., pwr])
    cv = dyn_constraint_violation(x, y)
    cv_costs = params.constraint_violation_penalty * plant.sum_last(
        cv.reshape(cv.shape[:-1] + (4, 4)))
    steam_pen = torch.relu(ambient_now[..., 4] - y[..., 28])
    energy_pen = torch.relu(ambient_now[..., 3] - y[..., 27])
    non_delivery = params.supply_imbalance_penalty * (steam_pen + energy_pen)
    reward = -(y[..., 21] + plant.sum_last(ramp) + non_delivery
               + plant.sum_last(cv_costs))
    info = {
        "fuel_costs": y[..., 6:9],          # per GT1..GT3 (ST = 0)
        "ramp_costs": ramp,                 # GT1, GT2, GT3, ST
        "dyn_cv_costs": cv_costs,           # GT1, GT2, GT3, ST
        "non_delivery_cost": non_delivery,
        "net_power": y[..., 27],
        "proc_steam": y[..., 28],
    }
    return reward, info


def sample_action(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 15) uniform actions on the generator's device: Box
    components uniform, switches Bernoulli(1/2), bays uniform integers
    1..12. Copies no host data (a CUDA graph may capture it)."""
    dev = generator.device
    low = device_const(ACTION_LOW, dev)
    high = device_const(ACTION_HIGH, dev)
    u = draw_env_rows(lambda b: torch.rand(
        (b, len(ACTION_KEYS)), generator=generator, device=dev), batch)
    a = low + u * (high - low)
    bins = draw_env_rows(lambda b: torch.rand(
        (b, len(BINARY_IDX)), generator=generator, device=dev), batch) < 0.5
    a[:, device_index(BINARY_IDX, dev)] = bins.float()
    a[:, BAYS_IDX] = draw_env_rows(lambda b: torch.randint(
        1, 13, (b,), generator=generator, device=dev), batch).float()
    return a


class CogenEnv(FunctionalEnv[CogenParams, CogenState]):
    name = "cogen"

    def sample_action(self, params: CogenParams, generator: torch.Generator,
                      batch: int) -> torch.Tensor:
        return sample_action(generator, batch).to(params.device)

    # ---- obs ------------------------------------------------------------
    def _noisy(self, params: CogenParams, window: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """(B, h+1, 7) forecast window with iid N(0, std^2) noise on the
        future rows (row 0, the current time, stays exact)."""
        if params.forecast_noise_std == 0.0:
            return window
        if generator is None:
            raise ValueError("noisy forecasts need a torch.Generator")
        shape = window[:, 1:].shape
        noise = params.forecast_noise_std * draw_env_rows(
            lambda b: torch.randn((b,) + shape[1:], generator=generator,
                                  device=generator.device), shape[0])
        return torch.cat([window[:, :1], window[:, 1:] + noise.to(
            window.device)], 1)

    @staticmethod
    def _obs(params: CogenParams, t: torch.Tensor, prev_action: torch.Tensor,
             window: torch.Tensor) -> dict[str, torch.Tensor]:
        """Obs dict from the steps ``t`` (...), the previous actions
        (..., 15) and the forecast windows (..., h+1, 7)."""
        obs = {"Time": (t / params.timesteps_per_day).float()[..., None],
               "Prev_Action": prev_action}
        for i, name in enumerate(FORECAST_KEYS):
            obs[name] = window[..., i]
        return obs

    def _slab_obs(self, params: CogenParams, t: torch.Tensor,
                  prev_action: torch.Tensor, slab: torch.Tensor,
                  generator) -> dict[str, torch.Tensor]:
        """Obs of envs whose day slab (B, 7, rows) is rolled to step t."""
        h = params.forecast_horizon
        return self._obs(params, t, prev_action, self._noisy(
            params, slab[..., :h + 1].transpose(1, 2), generator))


    # ---- seeding --------------------------------------------------------
    @staticmethod
    def day_from_seed(params: CogenParams, seed: int) -> int:
        """seed -> episode day: ``seed % n_days``, as the JAX package's
        ``CogenEnv.day_from_seed``."""
        return seed % params.n_days

    # ---- batched API ----------------------------------------------------
    def reset(self, params: CogenParams, generator: torch.Generator,
              batch: int) -> tuple[CogenState, TimeStep]:
        """``batch`` envs on days drawn from ``generator``: uniform over
        0 .. n_days - 2. The JAX package draws randint(0, n_days - 1), which
        never picks the last day; the port keeps that range."""
        day = draw_env_rows(lambda b: torch.randint(
            params.n_days - 1, (b,), generator=generator,
            device=generator.device), batch)
        return self.reset_at_day(params, day, generator)

    def reset_at_day(self, params: CogenParams, day,
                     generator: torch.Generator | None = None,
                     prev_action=None) -> tuple[CogenState, TimeStep]:
        """Envs at the start of ``day`` (B,); the previous action is
        ``prev_action`` (B, 15) or drawn from ``generator``."""
        dev = params.device
        day = torch.as_tensor(day, dtype=torch.long, device=dev).reshape(-1)
        B = day.shape[0]
        if prev_action is None:
            if generator is None:
                raise ValueError("pass prev_action or a torch.Generator")
            prev_action = self.sample_action(params, generator, B)
        prev_action = torch.as_tensor(prev_action, dtype=torch.float32,
                                      device=dev).reshape(B, -1)
        t = torch.zeros(B, dtype=torch.long, device=dev)
        slab = params.ambients[day].transpose(1, 2).contiguous()
        state = CogenState(day=day, t=t, prev_action=prev_action, slab=slab)
        obs = self._slab_obs(params, t, prev_action, slab, generator)
        zero = torch.zeros(B, dtype=torch.float32, device=dev)
        ts = TimeStep(obs=obs, reward=zero,
                      terminated=torch.zeros(B, dtype=torch.bool, device=dev),
                      truncated=torch.zeros(B, dtype=torch.bool, device=dev),
                      info=self._zero_info(B, dev))
        return state, ts

    def step(self, params: CogenParams, state: CogenState, action,
             generator: torch.Generator | None = None
             ) -> tuple[CogenState, TimeStep]:
        """One step of every env. The reward is computed against the
        current true ambient row (slab column 0); the next obs reads the
        rolled slab."""
        action = torch.as_tensor(action, dtype=torch.float32,
                                 device=params.device)
        reward, info = step_core(params, state.prev_action, action,
                                 state.slab[..., 0])
        slab = torch.roll(state.slab, -1, dims=-1)
        t = state.t + 1
        obs = self._slab_obs(params, t, action, slab, generator)
        new_state = CogenState(day=state.day, t=t, prev_action=action,
                               slab=slab)
        return new_state, TimeStep(
            obs=obs, reward=reward, terminated=t >= params.timesteps_per_day,
            truncated=torch.zeros_like(t, dtype=torch.bool), info=info)

    def episode_steps(self, params: CogenParams) -> int:
        return int(params.timesteps_per_day)

    # ---- lockstep episode paths ------------------------------------------
    def _episode_start(self, params: CogenParams, ep: int, batch: int,
                       generator, days, prev_action):
        """(day, prev_action, reset obs) of episode ``ep``: from the
        prescribed ``days`` (episodes, B) and ``prev_action`` (episodes, B,
        15), else drawn by :meth:`reset` from ``generator``."""
        if days is None:
            state, ts = self.reset(params, generator, batch)
        else:
            days = torch.as_tensor(days, dtype=torch.long).reshape(-1, batch)
            if ep >= days.shape[0]:
                raise ValueError(f"need reset days for {ep + 1} episodes, "
                                 f"got {days.shape[0]}")
            state, ts = self.reset_at_day(
                params, days[ep], generator,
                None if prev_action is None else prev_action[ep])
        return state.day, state.prev_action, ts.obs

    def batch_unroll(self, params: CogenParams, policy, policy_params,
                     batch: int, num_steps: int,
                     generator: torch.Generator | None = None, days=None,
                     prev_action=None, graphs=None) -> TimeStep:
        """Lockstep rollout with one ambient gather per episode: each env's
        padded day (96 + h + 1 rows) is fetched once with the slice-gather
        kernel (``ops/cuda/exog_gather.py``) and stepped time-major by
        ``step_core``; the forecast window of step t is rows t+1 .. t+1+h
        of the block. ``policy(policy_params, obs, generator)`` returns (B,
        15) actions. At each episode boundary the last step's obs is the
        next episode's reset obs (autoreset). Resets are drawn from
        ``generator`` in the order :func:`core.batch_rollout`'s autoreset
        path draws them, or prescribed by ``days`` / ``prev_action``
        ((num_steps // 96 + 1, B) / (..., B, 15)).

        Each episode starts eagerly (the reset draws and the gather, whose
        range check waits on the host); its step loop
        (:meth:`_episode_steps`) is one replay of a CUDA graph in
        ``graphs`` when given (:func:`core.rollout.episode_loop`), which
        the result then holds until the graph's next replay."""
        from ...ops.cuda.exog_gather import episode_slice_gather

        L, h = params.timesteps_per_day, params.forecast_horizon
        rows = L + h + 1
        flat = params.ambients.reshape(-1, params.ambients.shape[-1])
        day, prev, obs = self._episode_start(params, 0, batch, generator,
                                             days, prev_action)
        parts = []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            block = episode_slice_gather(flat, day * rows, rows).transpose(0, 1)
            traj = episode_loop(
                graphs, partial(self._episode_steps, params, policy,
                                policy_params, seg, generator),
                obs, prev, block, generator=generator,
                clone=t0 + seg < num_steps)
            if seg == L:
                day, prev, obs = self._episode_start(params, ep + 1, batch,
                                                     generator, days,
                                                     prev_action)
                for k, v in obs.items():
                    traj.obs[k][-1] = v
            parts.append(traj)
        return join_episodes(parts)

    def _episode_steps(self, params: CogenParams, policy, policy_params,
                       seg: int, generator, obs, prev, block) -> TimeStep:
        """``seg`` steps of an episode from its reset ``obs`` and previous
        actions ``prev`` over its gathered ambient ``block`` (rows, B, 7):
        the part of :meth:`batch_unroll` that a CUDA graph captures."""
        L, h = params.timesteps_per_day, params.forecast_horizon
        batch, dev = prev.shape[0], params.device
        traj = []
        for t in range(seg):
            actions = torch.as_tensor(policy(policy_params, obs, generator),
                                      dtype=torch.float32, device=dev)
            reward, info = step_core(params, prev, actions, block[t])
            t_next = torch.full((batch,), t + 1, dtype=torch.long,
                                device=dev)
            window = self._noisy(
                params, block[t + 1:t + h + 2].transpose(0, 1), generator)
            obs = self._obs(params, t_next, actions, window)
            traj.append(TimeStep(
                obs=obs, reward=reward, terminated=t_next >= L,
                truncated=torch.zeros_like(t_next, dtype=torch.bool),
                info=info))
            prev = actions
        return tree_stack(traj)

    def fused_rollout(self, params: CogenParams, batch: int, num_steps: int,
                      generator: torch.Generator | None = None,
                      actions: torch.Tensor | None = None, days=None,
                      prev_action=None) -> TimeStep:
        """Simulation tier: per episode, one slice-gather launch for the
        envs' ambient days (the obs windows) and one launch of the episode
        kernel (``ops/cuda/cogen_rollout.py::cogen_segment``) for the
        actions, rewards and info of every step.

        Actions are drawn in the kernel (Box components uniform, switches
        Bernoulli(1/2), bays uniform integers 1..12) from a Philox stream
        seeded from ``generator``, or prescribed as ``actions`` (num_steps,
        B, 15). Noisy forecasts hand over to :meth:`batch_unroll` with a
        uniform random policy, as the JAX package does. Resets as in
        :meth:`batch_unroll`."""
        from ...core.rollout import random_policy
        from ...ops.cuda.cogen_rollout import cogen_segment, segment_fields
        from ...ops.cuda.exog_gather import episode_slice_gather

        if params.forecast_noise_std != 0.0:
            if actions is not None:
                raise ValueError("fused_rollout with prescribed actions needs "
                                 "noiseless forecasts")
            return self.batch_unroll(params, random_policy(self, params, batch),
                                     None, batch, num_steps, generator, days,
                                     prev_action)
        L, h = params.timesteps_per_day, params.forecast_horizon
        rows, dev = L + h + 1, params.device
        flat = params.ambients.reshape(-1, params.ambients.shape[-1])
        day, prev, _ = self._episode_start(params, 0, batch, generator, days,
                                           prev_action)
        parts = []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            block = episode_slice_gather(flat, day * rows, rows)
            if actions is None:
                acts, seed = None, kernel_seed(generator)
            else:
                acts, seed = actions[t0:t0 + seg], 0
            out = cogen_segment(params, day, prev, seg, actions=acts,
                                seed=seed)
            action, reward, info = segment_fields(out)
            # obs at t+1: the forecast windows at block rows t+1 .. t+1+h
            window = block.unfold(1, h + 1, 1)[:, 1:seg + 1].permute(
                1, 0, 3, 2).contiguous()                 # (seg, B, h+1, 7)
            t_next = torch.arange(1, seg + 1, device=dev)[:, None].expand(
                seg, batch)
            obs = self._obs(params, t_next, action, window)
            done = torch.zeros((seg, batch), dtype=torch.bool, device=dev)
            prev = action[-1].contiguous()
            if seg == L:
                done[-1] = True
                day, prev, obs_r = self._episode_start(params, ep + 1, batch,
                                                       generator, days,
                                                       prev_action)
                for k, v in obs_r.items():
                    obs[k][-1] = v
            parts.append(TimeStep(obs=obs, reward=reward, terminated=done,
                                  truncated=torch.zeros_like(done),
                                  info=info))
        if len(parts) == 1:
            return parts[0]
        return tree_map(lambda *xs: torch.cat(xs), *parts)

    @staticmethod
    def _zero_info(batch: int, device) -> dict[str, torch.Tensor]:
        def z(*shape):
            return torch.zeros((batch,) + shape, dtype=torch.float32,
                               device=device)
        return {"fuel_costs": z(3), "ramp_costs": z(4), "dyn_cv_costs": z(4),
                "non_delivery_cost": z(), "net_power": z(), "proc_steam": z()}

    # ---- metadata -------------------------------------------------------
    def action_space(self, params: CogenParams) -> Box:
        return Box(ACTION_LOW, ACTION_HIGH)

    def observation_space(self, params: CogenParams) -> DictSpace:
        h = params.forecast_horizon
        return DictSpace({
            "Time": Box(0, 1, (1,)),
            "Prev_Action": Box(ACTION_LOW, ACTION_HIGH),
            "TAMB": Box(32, 115, (h + 1,)),
            "PAMB": Box(14, 15, (h + 1,)),
            "RHAMB": Box(0, 1, (h + 1,)),
            "Target_Power": Box(0, 700, (h + 1,)),
            "Target_Steam": Box(0, 1300, (h + 1,)),
            "Energy_Price": Box(0, 1500, (h + 1,)),
            "Gas_Price": Box(0, 7, (h + 1,)),
        })
