"""DataCenterEnv in PyTorch — carbon-aware job scheduling via virtual
capacity curves.

The port of ``sustaingym_tpu.envs.datacenter.env``, with the batch axis
written out (every state tensor is (B,)). An episode is one calendar month
cut to 28 days of hourly steps (672). The action is the virtual capacity
curve a(t) in [0, 1], the share of capacity C the scheduler may use in the
next hour; jobs arrive as job-hours and run FIFO up to a(t) C. The reward
is -(executed load x MOER + the daily delay penalty
max(0, 0.97 w - C sum a) at each 24-hour boundary); the observation (27,)
is [a(t-1), executed load, jobs waiting, 24-hour MOER forecast].

``step_core`` is the one formula of a step: :meth:`DataCenterEnv.step`,
:meth:`DataCenterEnv.batch_unroll` and the plain version of the episode
kernel (``ops/cuda/dc_rollout.py``) all call it. The exogenous rows are
read by direct indexing ``table[month, t]``: the JAX package's one-hot
window contraction exists only to avoid lane-padded gathers on the TPU.
Whole episodes run through the CUDA kernels of ``ops/cuda`` in
:meth:`DataCenterEnv.batch_unroll` (the per-episode month-row gather) and
:meth:`DataCenterEnv.fused_rollout` (the gather and the episode kernel).
Random draws come from a ``torch.Generator``.
"""
from __future__ import annotations

import datetime as dt

from functools import partial

import numpy as np
import torch

from ...core import (Box, FunctionalEnv, TimeStep, dataclass, draw_env_rows,
                     kernel_seed, resolve_device, tree_map, tree_stack)
from ...core.rollout import episode_loop, join_episodes

HOURS_PER_DAY = 24
EPISODE_DAYS = 28
EPISODE_LEN = HOURS_PER_DAY * EPISODE_DAYS  # 672
FORECAST_H = 24
CAPACITY = 1.0            # normalized datacenter capacity C
DELAY_FACTOR = 0.97       # the doc's 0.97 w_t
AVG_JOB_SIZE = 0.02       # job-hours per job (the jobs-waiting obs)

MONTH_RANGE_START = (2019, 5)
MONTH_RANGE_END = (2021, 8)


@dataclass
class DCParams:
    # (n_months, 672 + 24, 2): per hour [job-hours arriving (zero after
    # hour 672), MOER kg/kWh]; the env and the kernels read this one table
    table: torch.Tensor
    n_months: int

    @property
    def device(self) -> torch.device:
        return self.table.device


@dataclass
class DCState:
    month: torch.Tensor         # (B,) int64 episode month
    t: torch.Tensor             # (B,) int64 hour within the episode
    queue: torch.Tensor         # (B,) backlog job-hours
    prev_a: torch.Tensor        # (B,) previous VCC
    running: torch.Tensor       # (B,) executed load last hour (d_t)
    day_vcc_sum: torch.Tensor   # (B,) sum of the VCC over the current day
    day_arrivals: torch.Tensor  # (B,) job-hours enqueued over the day


def _months() -> list[tuple[int, int]]:
    out = []
    y, m = MONTH_RANGE_START
    while (y, m) <= MONTH_RANGE_END:
        out.append((y, m))
        m += 1
        if m > 12:
            y, m = y + 1, 1
    return out


def _synthesize_arrivals(n_months: int, seed: int = 11) -> np.ndarray:
    """Deterministic cluster-trace-like arrivals: business-hours diurnal
    peak, weekday/weekend split, heavy-tailed bursts; the JAX package's
    ``default_rng(seed)`` stream, draw for draw."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_months, EPISODE_LEN))
    for mth in range(n_months):
        hours = np.arange(EPISODE_LEN)
        hod = hours % 24
        dow = (hours // 24) % 7
        diurnal = 0.35 + 0.3 * np.exp(-0.5 * ((hod - 14.5) / 3.5) ** 2)
        weekday = np.where(dow < 5, 1.0, 0.72)
        bursts = rng.pareto(3.0, EPISODE_LEN) * 0.05
        noise = rng.normal(scale=0.03, size=EPISODE_LEN)
        out[mth] = np.clip(diurnal * weekday + bursts + noise, 0.02, 1.5)
    return out


def make_params(device="cuda") -> DCParams:
    """The 28 monthly episodes 2019-05 .. 2021-08: hourly MOER (every 12th
    5-minute row of the packed SGIP CAISO SCE days, 696 hours) and the
    synthesized arrivals, on ``device`` (the card unless the caller asks
    for the CPU)."""
    from ...data.ev_etl import build_moer_pack
    device = resolve_device(device)
    months = _months()
    moer_rows = []
    for (y, m) in months:
        first = dt.date(y, m, 1)
        last = first + dt.timedelta(days=EPISODE_DAYS + 1)
        pack = build_moer_pack((first.isoformat(), last.isoformat()))
        hourly = pack[:, ::12, 0][:, :HOURS_PER_DAY]  # (days, 24)
        moer_rows.append(hourly.reshape(-1)[:EPISODE_LEN + FORECAST_H])
    arrivals = np.pad(_synthesize_arrivals(len(months)), ((0, 0),
                                                          (0, FORECAST_H)))
    table = np.stack([arrivals, np.stack(moer_rows)], -1).astype(np.float32)
    return DCParams(table=torch.as_tensor(table, device=device),
                    n_months=len(months))


def step_core(queue, day_vcc_sum, day_arrivals, a, arrivals, m_t, t):
    """One hour of the VCC fluid queue for a batch: clipped VCCs ``a``,
    the hour's arrival job-hours and MOER, at episode hours ``t`` (an int
    or (B,) tensor). Returns (queue, day_vcc_sum, day_arrivals, executed,
    carbon_cost, delay_penalty, reward), the day sums reset after a
    24-hour boundary."""
    backlog = queue + arrivals
    executed = torch.minimum(backlog, a * CAPACITY)
    queue = backlog - executed
    carbon_cost = executed * m_t
    day_vcc_sum = day_vcc_sum + a
    day_arrivals = day_arrivals + arrivals
    boundary = torch.as_tensor((t + 1) % HOURS_PER_DAY == 0,
                               device=queue.device)
    zero = torch.zeros_like(queue)
    delay_penalty = torch.where(
        boundary, torch.clamp_min(DELAY_FACTOR * day_arrivals
                                  - CAPACITY * day_vcc_sum, 0.0), zero)
    reward = -(carbon_cost + delay_penalty)
    return (queue, torch.where(boundary, zero, day_vcc_sum),
            torch.where(boundary, zero, day_arrivals), executed, carbon_cost,
            delay_penalty, reward)


class DataCenterEnv(FunctionalEnv[DCParams, DCState]):
    name = "datacenter"

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def month_from_seed(params: DCParams, seed: int) -> int:
        """seed -> episode month: ``seed % n_months``."""
        return seed % params.n_months

    def reset(self, params: DCParams, generator: torch.Generator,
              batch: int) -> tuple[DCState, TimeStep]:
        """``batch`` envs on months drawn uniformly from ``generator``."""
        month = draw_env_rows(lambda b: torch.randint(
            params.n_months, (b,), generator=generator,
            device=generator.device), batch)
        return self.reset_at_month(params, month)

    def reset_at_month(self, params: DCParams, month
                       ) -> tuple[DCState, TimeStep]:
        dev = params.device
        month = torch.as_tensor(month, dtype=torch.long, device=dev).reshape(-1)
        B = month.shape[0]
        z = torch.zeros(B, dtype=torch.float32, device=dev)
        state = DCState(month=month, t=torch.zeros_like(month), queue=z,
                        prev_a=torch.ones_like(z), running=z, day_vcc_sum=z,
                        day_arrivals=z)
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        ts = TimeStep(obs=self._obs(params, state), reward=z, terminated=no,
                      truncated=no,
                      info={"carbon_cost": z, "delay_penalty": z, "queue": z,
                            "executed": z})
        return state, ts

    def step(self, params: DCParams, state: DCState, action,
             generator: torch.Generator | None = None
             ) -> tuple[DCState, TimeStep]:
        """One hour of every env: the hour's arrivals and the MOER now and
        24 hours ahead, read from the month rows by index."""
        hours = state.t[:, None] + torch.arange(FORECAST_H + 1,
                                                device=params.device)
        window = params.table[state.month[:, None], hours]    # (B, 25, 2)
        return self._step_exog(params, state, action, window[:, 0, 0],
                               window[:, 0, 1], window[:, 1:, 1])

    def _step_exog(self, params: DCParams, state: DCState, action,
                   arrivals, m_t, fc) -> tuple[DCState, TimeStep]:
        """Step given the hour's exogenous values: arrival job-hours (B,),
        MOER now (B,) and the next 24 hours' MOER (B, 24); shared by
        :meth:`step` and :meth:`batch_unroll`."""
        B = state.t.shape[0]
        a = torch.as_tensor(action, dtype=torch.float32,
                            device=params.device).reshape(B).clamp(0.0, 1.0)
        queue, day_vcc, day_arr, executed, carbon, delay, reward = step_core(
            state.queue, state.day_vcc_sum, state.day_arrivals, a, arrivals,
            m_t, state.t)
        t = state.t + 1
        new_state = DCState(month=state.month, t=t, queue=queue, prev_a=a,
                            running=executed, day_vcc_sum=day_vcc,
                            day_arrivals=day_arr)
        obs = torch.cat([a[:, None], executed[:, None],
                         (queue / AVG_JOB_SIZE)[:, None], fc], -1)
        return new_state, TimeStep(
            obs=obs, reward=reward, terminated=t >= EPISODE_LEN,
            truncated=torch.zeros_like(t, dtype=torch.bool),
            info={"carbon_cost": carbon, "delay_penalty": delay,
                  "queue": queue, "executed": executed})

    def episode_steps(self, params: DCParams) -> int:
        return EPISODE_LEN

    # ---- lockstep episode paths ------------------------------------------
    def _episode_start(self, params: DCParams, ep: int, batch: int,
                       generator, months) -> tuple[DCState, TimeStep]:
        """Reset state and obs of episode ``ep``: months prescribed by
        ``months`` (episodes, B), else drawn by :meth:`reset`."""
        if months is None:
            return self.reset(params, generator, batch)
        months = torch.as_tensor(months, dtype=torch.long).reshape(-1, batch)
        if ep >= months.shape[0]:
            raise ValueError(f"need reset months for {ep + 1} episodes, got "
                             f"{months.shape[0]}")
        return self.reset_at_month(params, months[ep])

    def batch_unroll(self, params: DCParams, policy, policy_params,
                     batch: int, num_steps: int,
                     generator: torch.Generator | None = None,
                     months=None, graphs=None) -> TimeStep:
        """Lockstep rollout with one month-row gather per episode: each
        env's 696 [arrivals, MOER] rows are fetched once with the
        slice-gather kernel (``ops/cuda/exog_gather.py``) and stepped
        time-major by ``step_core``; the forecast of step t is rows
        t+1 .. t+24 of the block. ``policy(policy_params, obs, generator)``
        returns (B,) or (B, 1) VCCs. At each episode boundary the last
        step's obs is the next episode's reset obs (autoreset). Resets are
        drawn from ``generator`` in the order the generic autoreset path
        draws them, or prescribed by ``months`` ((num_steps // 672 + 1,
        B)).

        Each episode starts eagerly (the reset draws and the gather, whose
        range check waits on the host); its step loop
        (:meth:`_episode_steps`) is one replay of a CUDA graph in
        ``graphs`` when given (:func:`core.rollout.episode_loop`), which
        the result then holds until the graph's next replay."""
        from ...ops.cuda.exog_gather import episode_slice_gather

        L, rows = EPISODE_LEN, params.table.shape[1]
        flat = params.table.reshape(-1, 2)
        state, ts = self._episode_start(params, 0, batch, generator, months)
        obs, parts = ts.obs, []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            block = episode_slice_gather(flat, state.month * rows,
                                         rows).transpose(0, 1)  # (rows, B, 2)
            traj = episode_loop(
                graphs, partial(self._episode_steps, params, policy,
                                policy_params, seg, generator),
                state, obs, block, generator=generator,
                clone=t0 + seg < num_steps)
            if seg == L:
                state, ts_r = self._episode_start(params, ep + 1, batch,
                                                  generator, months)
                obs = ts_r.obs
                traj.obs[-1] = obs
            parts.append(traj)
        return join_episodes(parts)

    def _episode_steps(self, params: DCParams, policy, policy_params,
                       seg: int, generator, state: DCState, obs,
                       block) -> TimeStep:
        """``seg`` steps of an episode from ``state`` and its ``obs`` over
        its gathered month ``block`` (rows, B, 2): the part of
        :meth:`batch_unroll` that a CUDA graph captures."""
        traj = []
        for t in range(seg):
            actions = policy(policy_params, obs, generator)
            state, ts = self._step_exog(
                params, state, actions, block[t, :, 0], block[t, :, 1],
                block[t + 1:t + 1 + FORECAST_H, :, 1].T)
            obs = ts.obs
            traj.append(ts)
        return tree_stack(traj)

    def fused_rollout(self, params: DCParams, batch: int, num_steps: int,
                      generator: torch.Generator | None = None,
                      actions: torch.Tensor | None = None,
                      months=None) -> TimeStep:
        """Simulation tier: per episode, one slice-gather launch for the
        envs' month rows (the obs forecasts) and one launch of the episode
        kernel (``ops/cuda/dc_rollout.py::dc_segment``) for the VCCs,
        queue, rewards and info of every hour.

        VCCs are drawn U(0, 1) in the kernel from a Philox stream seeded
        from ``generator``, or prescribed as ``actions`` (num_steps, B) or
        (num_steps, B, 1). Resets as in :meth:`batch_unroll`.

        Memory: the obs alone are num_steps x B x 27 float32 (19.0 GB at
        672 x 262144); the kernel's rows (6 per step) hold the reward and
        info as views."""
        from ...ops.cuda.dc_rollout import dc_segment
        from ...ops.cuda.exog_gather import episode_slice_gather

        L, rows, dev = EPISODE_LEN, params.table.shape[1], params.device
        flat = params.table.reshape(-1, 2)
        month = self._episode_start(params, 0, batch, generator,
                                    months)[0].month
        parts = []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            block = episode_slice_gather(flat, month * rows, rows)
            if actions is None:
                acts, seed = None, kernel_seed(generator)
            else:
                acts = actions[t0:t0 + seg].reshape(seg, batch).contiguous()
                seed = 0
            a, executed, queue, reward, carbon, delay = dc_segment(
                params, month, seg, actions=acts, seed=seed)
            obs = torch.empty((seg, batch, 3 + FORECAST_H),
                              dtype=torch.float32, device=dev)
            obs[..., 0] = a
            obs[..., 1] = executed
            obs[..., 2] = queue / AVG_JOB_SIZE
            # the forecast after step t: block rows t+1 .. t+24
            obs[..., 3:] = block[..., 1].unfold(1, FORECAST_H, 1)[
                :, 1:seg + 1].transpose(0, 1)
            done = torch.zeros((seg, batch), dtype=torch.bool, device=dev)
            if seg == L:
                done[-1] = True
                state, ts_r = self._episode_start(params, ep + 1, batch,
                                                  generator, months)
                month = state.month
                obs[-1] = ts_r.obs
            parts.append(TimeStep(
                obs=obs, reward=reward, terminated=done,
                truncated=torch.zeros_like(done),
                info={"carbon_cost": carbon, "delay_penalty": delay,
                      "queue": queue, "executed": executed}))
        if len(parts) == 1:
            return parts[0]
        return tree_map(lambda *xs: torch.cat(xs), *parts)

    @staticmethod
    def _obs(params: DCParams, state: DCState) -> torch.Tensor:
        """(B, 27) = [a(t-1), d_t, n_waiting, MOER forecast 24 h]."""
        hours = state.t[:, None] + torch.arange(FORECAST_H,
                                                device=params.device)
        fc = params.table[state.month[:, None], hours, 1]
        return torch.cat([state.prev_a[:, None], state.running[:, None],
                          (state.queue / AVG_JOB_SIZE)[:, None], fc], -1)

    # ---- metadata -------------------------------------------------------
    def observation_space(self, params: DCParams) -> Box:
        low = np.concatenate([[0, 0, 0], np.zeros(FORECAST_H)])
        high = np.concatenate([[1, CAPACITY, 1e5], np.ones(FORECAST_H)])
        return Box(low, high)

    def action_space(self, params: DCParams) -> Box:
        return Box(0.0, 1.0, (1,))
