"""EVChargingEnv in PyTorch — a batched EV charging-network simulation.

The port of ``sustaingym_tpu.envs.evcharging.env``: the same fixed-size
station-slot state advanced by a step function, with the batch axis written
out (every state tensor is (B, ...)) instead of vmapped.

Per step (5 simulated minutes):
 1. optional action projection onto the network feasible set (dual FISTA
    or ADMM, ``ops/qp.py``);
 2. EVSE pilot quantization — AV: {0,8,16,24,32}, CC: {0} U {6..32}
    (round half to even, like ``np.round``);
 3. plug/unplug events from the compiled day table;
 4. two-stage battery charging;
 5. reward = profit - carbon cost - excess network charge.

Whole episodes run in the CUDA kernels of ``ops/cuda/ev_rollout.py``
through :meth:`EVChargingEnv.fused_rollout` (simulation tier) and
:meth:`EVChargingEnv.fused_policy_unroll` (PPO rollouts);
:meth:`EVChargingEnv.batch_unroll` steps a lockstep batch under any policy.
Each takes the reset days explicitly, or draws them from a
``torch.Generator``. Under a ``core.trace`` recording each episode of the
two fused calls is an ``ev.fused_rollout`` span, whose child
``ev.prelaunch`` runs from the episode's entry (the first episode's holds
the day draws) to its kernel's launch.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ...core import (Box, DictSpace, FunctionalEnv, TimeStep, dataclass,
                     draw_env_rows, env_offset, kernel_seed, resolve_device,
                     trace, tree_stack)
from ...core.rollout import episode_loop, join_episodes
from ...ops import qp
from .sites import SiteSpec, load_site

# Reward constants (reference env.py:99-114)
TIMESTEP_DURATION = 5
ACTION_SCALE_FACTOR = 32.0
VOLTAGE = 208.0
MARGINAL_PROFIT_PER_KWH = 0.15 * 0.20
CO2_COST_PER_METRIC_TON = 30.85
A_MINS_TO_KWH = (1 / 60) * (VOLTAGE / 1000)
VIOLATION_WEIGHT = 0.001
A_PERS_TO_KWH = A_MINS_TO_KWH * TIMESTEP_DURATION
PROFIT_FACTOR = A_PERS_TO_KWH * MARGINAL_PROFIT_PER_KWH
VIOLATION_FACTOR = A_PERS_TO_KWH * VIOLATION_WEIGHT
CARBON_COST_FACTOR = A_PERS_TO_KWH * (CO2_COST_PER_METRIC_TON / 1000)

MAX_TIMESTEP = 288

# Battery constants
BATTERY_CAPACITY = 100.0
BATTERY_MAX_POWER = 100.0
TRANSITION_SOC = 0.8


@dataclass
class EVParams:
    # data packs
    moer: torch.Tensor          # (n_days, 289, 37)
    day_max_profit: torch.Tensor  # (n_days,)
    day_num_evs: torch.Tensor     # (n_days,) int32
    # per-(day, t) step table: [plug_dep(n) | plug_est(n) | plug_req(n) |
    # moer(t+1)(37) | max_profit | num_evs]; the kernels index it directly
    step_table: torch.Tensor    # (n_days, 289, 3n + 39)
    # network constants
    constraint_re: torch.Tensor  # (m, n) Re(A~)
    constraint_im: torch.Tensor  # (m, n) Im(A~)
    magnitudes: torch.Tensor     # (m,)
    min_pilots: torch.Tensor     # (n,)
    proj: qp.DualSOCProjection | qp.SOCProjection
    n_stations: int
    n_days: int
    moer_forecast_steps: int = 36
    project_action: bool = True
    site: str = "caltech"

    @property
    def device(self) -> torch.device:
        return self.step_table.device


@dataclass
class EVState:
    day: torch.Tensor       # (B,) int64
    t: torch.Tensor         # (B,) int64
    plugged: torch.Tensor   # (B, n) bool
    dep: torch.Tensor       # (B, n) int64 true departure period
    est_dep: torch.Tensor   # (B, n) int64 estimated departure period
    demand: torch.Tensor    # (B, n) float32 remaining demand (kWh)


def make_params(site: str = "caltech", date_period="Summer 2021",
                moer_forecast_steps: int = 36, project_action: bool = True,
                requested_energy_cap: float = 100.0,
                proj_method: str = "dual", proj_iters: int | None = None,
                trace: str = "real", gmm_days: int = 200,
                gmm_components: int = 30, device="cuda") -> EVParams:
    """Compiles the sessions of ``site`` over ``date_period`` into step
    tables (host NumPy) and places every tensor on ``device`` (the card
    unless the caller asks for the CPU).

    ``trace="real"``: the ACN sessions of the site's stations
    (RealTraceGenerator analogue, ``data/ev_etl.build_trace_pack``),
    requested energy capped at ``requested_energy_cap``: a cap up to the
    shipped packs' 100 kWh is applied to the packed days, a larger one
    builds them from the raw sessions. The JAX package's cached pack
    ignores the cap; the port does not copy that.
    ``trace="gmm"``: a bank of ``gmm_days`` days sampled from the packaged
    ``gmm_components``-component mixture (GMMsTraceGenerator analogue,
    ``data/ev_gmm.py``), requested energy capped at
    ``requested_energy_cap``; the MOER days cycle under a longer bank.

    ``proj_method``: ``"dual"`` (preconditioned dual FISTA, 15 iterations
    by default) or ``"admm"`` (over-relaxed ADMM, 30); ``proj_iters``
    overrides the count."""
    device = resolve_device(device)
    from ...data.ev_etl import build_moer_pack, build_trace_pack
    spec: SiteSpec = load_site(site)
    moer = build_moer_pack(date_period)
    if trace == "gmm":
        from ...data.ev_gmm import build_gmm_trace_pack
        traces = build_gmm_trace_pack(
            site, date_period, n_days=gmm_days, n_components=gmm_components,
            requested_energy_cap=requested_energy_cap)
        n_bank = traces["ev_data"].shape[0]
        moer = np.tile(moer, (-(-n_bank // moer.shape[0]), 1, 1))[:n_bank]
    elif trace == "real":
        traces = build_trace_pack(site, date_period, spec.station_ids,
                                  requested_energy_cap=requested_energy_cap)
    else:
        raise ValueError(f"unknown trace {trace!r}")
    phase = np.exp(1j * np.deg2rad(spec.phase_angles))
    a_tilde = spec.constraint_matrix * phase[None, :]
    net = (spec.constraint_matrix, spec.phase_angles, spec.magnitudes)
    if proj_method == "dual":
        proj = qp.make_dual_soc_projection(
            *net, action_scale=ACTION_SCALE_FACTOR,
            iters=15 if proj_iters is None else proj_iters, device=device)
    elif proj_method == "admm":
        proj = qp.make_soc_projection(
            *net, action_scale=ACTION_SCALE_FACTOR,
            iters=30 if proj_iters is None else proj_iters, device=device)
    else:
        raise ValueError(f"unknown proj_method {proj_method!r}")

    ev = traces["ev_data"]
    st = traces["ev_station"]
    msk = traces["ev_mask"]
    n_days_tr = ev.shape[0]
    n = spec.num_stations
    grid_shape = (n_days_tr, MAX_TIMESTEP + 1, n)
    plug_dep = np.zeros(grid_shape, np.float32)
    plug_est = np.zeros(grid_shape, np.float32)
    plug_req = np.zeros(grid_shape, np.float32)
    for d in range(n_days_tr):
        for k in range(ev.shape[1]):
            if not msk[d, k]:
                continue
            t0 = int(ev[d, k, 0])
            plug_dep[d, t0, st[d, k]] = ev[d, k, 1]
            plug_est[d, t0, st[d, k]] = ev[d, k, 2]
            plug_req[d, t0, st[d, k]] = ev[d, k, 3]
    dur = (ev[..., 1] - ev[..., 0]) * msk
    max_kwh = np.minimum(ev[..., 3], dur * ACTION_SCALE_FACTOR * A_PERS_TO_KWH)
    day_max_profit = (max_kwh * msk).sum(axis=1) * MARGINAL_PROFIT_PER_KWH
    day_num_evs = msk.sum(axis=1).astype(np.int32)

    moer_np = np.asarray(moer, np.float32)
    moer_next = np.concatenate(
        [moer_np[:, 1:, :], moer_np[:, -1:, :]], axis=1)  # row t -> moer t+1
    step_table = np.concatenate([
        plug_dep, plug_est, plug_req, moer_next,
        np.broadcast_to(day_max_profit[:, None, None].astype(np.float32),
                        grid_shape[:2] + (1,)),
        np.broadcast_to(day_num_evs[:, None, None].astype(np.float32),
                        grid_shape[:2] + (1,)),
    ], axis=2)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    return EVParams(
        moer=f32(moer),
        day_max_profit=f32(day_max_profit),
        day_num_evs=torch.as_tensor(day_num_evs, device=device),
        step_table=f32(step_table).contiguous(),
        constraint_re=f32(a_tilde.real),
        constraint_im=f32(a_tilde.imag),
        magnitudes=f32(spec.magnitudes),
        min_pilots=f32(spec.min_pilots),
        proj=proj,
        n_stations=n,
        n_days=int(moer.shape[0]),
        moer_forecast_steps=int(moer_forecast_steps),
        project_action=bool(project_action),
        site=site,
    )


def quantize_pilots(norm_action: torch.Tensor, min_pilots: torch.Tensor
                    ) -> torch.Tensor:
    """normalized [0,1] action -> pilot signal in amps. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    amps = norm_action * ACTION_SCALE_FACTOR
    cc = torch.where(amps >= 6.0, torch.round(amps), 0.0)
    av = torch.round(amps / 8.0) * 8.0
    return torch.where(min_pilots == 6.0, cc, av)


def battery_charge(pilot_amps: torch.Tensor, demand: torch.Tensor,
                   plugged: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage battery model, elementwise over stations: every battery
    has capacity 100 kWh, so soc = 1 - demand / capacity. Returns (actual
    charging rate in A, energy delivered in kWh)."""
    pilot_kw = pilot_amps * VOLTAGE / 1000.0
    soc = 1.0 - demand / BATTERY_CAPACITY
    taper_kw = BATTERY_MAX_POWER * (1.0 - soc) / (1.0 - TRANSITION_SOC)
    cap_kw = torch.where(soc < TRANSITION_SOC, BATTERY_MAX_POWER, taper_kw)
    power = torch.minimum(pilot_kw, cap_kw)
    # cannot exceed remaining capacity within one period
    power = torch.minimum(power, demand * (60.0 / TIMESTEP_DURATION))
    power = torch.where(plugged, torch.clamp(power, min=0.0), 0.0)
    energy = power * (TIMESTEP_DURATION / 60.0)
    rate_amps = power * 1000.0 / VOLTAGE
    return rate_amps, energy


def advance(params: EVParams, state: EVState, action: torch.Tensor, row: torch.Tensor
            ) -> tuple[EVState, torch.Tensor, dict[str, torch.Tensor]]:
    """One batched env step given the packed (day, t) table rows (B, W):
    projection, quantization, events, battery, reward. The env and the
    plain versions of the kernels share this code. Returns
    (next state, reward (B,), {profit, carbon_cost, excess_charge})."""
    n = params.n_stations
    action = torch.clamp(action, 0.0, 1.0)
    if params.project_action:
        # upper bound from the demands the agent observed (pre-event)
        demands_obs = torch.where(state.plugged, state.demand, 0.0)
        ub = torch.clamp(demands_obs / A_PERS_TO_KWH / ACTION_SCALE_FACTOR,
                         max=1.0)
        action = qp.project(params.proj, action, ub)
    pilots = quantize_pilots(action, params.min_pilots)

    # events at step t: unplug (departure == t), then arrivals take the slot
    dep_row = row[:, :n]
    plugged = state.plugged & (state.dep != state.t[:, None])
    arrive = dep_row > 0
    plugged = plugged | arrive
    dep = torch.where(arrive, dep_row.long(), state.dep)
    est_dep = torch.where(arrive, row[:, n:2 * n].long(), state.est_dep)
    demand = torch.where(arrive, row[:, 2 * n:3 * n], state.demand)

    rates, energy = battery_charge(pilots, demand, plugged)
    demand = demand - energy

    # reward: carbon is priced at the post-increment row moer(t+1)[0]
    total_rate = torch.sum(rates, -1)
    profit = PROFIT_FACTOR * total_rate
    agg = (pilots @ params.proj.C.T).reshape(pilots.shape[0], -1, 2)
    current_mag = torch.sqrt(torch.sum(agg * agg, -1))
    # padded cones (none in the packaged sites) add exactly 0
    excess = torch.sum(torch.where(
        params.magnitudes > 0.0,
        torch.clamp(current_mag - params.magnitudes, min=0.0), 0.0), -1)
    excess_charge = excess * VIOLATION_FACTOR
    carbon_cost = CARBON_COST_FACTOR * total_rate * row[:, 3 * n]
    reward = profit - carbon_cost - excess_charge
    new_state = EVState(day=state.day, t=state.t + 1, plugged=plugged,
                        dep=dep, est_dep=est_dep, demand=demand)
    return new_state, reward, {"profit": profit, "carbon_cost": carbon_cost,
                               "excess_charge": excess_charge}


def _set_last(tree, value) -> None:
    """Writes ``value`` into the last time row of every leaf of ``tree``
    (a tensor or a dict of tensors, as an obs is)."""
    if isinstance(tree, torch.Tensor):
        tree[-1] = value
    else:
        for k in tree:
            _set_last(tree[k], value[k])


def lockstep_unroll(params, reset_fn, reset_at_day_fn, step_row_fn, policy,
                    policy_params, batch: int, num_steps: int,
                    generator: torch.Generator | None = None, days=None,
                    graphs=None) -> TimeStep:
    """The lockstep episode loop behind :meth:`EVChargingEnv.batch_unroll`
    and the multi-agent view's (``envs/multiagent.py``), as the JAX
    package's ``_lockstep_ev_unroll`` serves both: the view adds its
    staleness ring and per-agent obs around the same (day, t) rows.

    ``reset_fn(generator, batch)`` and ``reset_at_day_fn(days)`` reset the
    batch; ``step_row_fn(params, state, action, row)`` steps it given the
    rows ``params.step_table[state.day, t]``; obs may be any tree (a dict
    or a tensor). ``step_row_fn`` names a graph's capture (with
    ``params``, the policy and the generator): pass a function or a bound
    method, not a new closure per call. Resets and ``days`` as in
    :meth:`EVChargingEnv.batch_unroll`;
    each episode starts eagerly (its reset draws), and its step loop is
    one replay of a graph in ``graphs`` when given."""
    L = MAX_TIMESTEP
    if days is not None:
        days = torch.as_tensor(days, dtype=torch.long,
                               device=params.device).reshape(-1, batch)

    def start(ep: int):
        if days is None:
            if generator is None:
                raise ValueError("pass reset `days` or a torch.Generator")
            return reset_fn(generator, batch)
        if ep >= days.shape[0]:
            raise ValueError(f"need reset days for {ep + 1} episodes, "
                             f"got {days.shape[0]}")
        return reset_at_day_fn(days[ep])

    state, ts = start(0)
    obs, parts = ts.obs, []
    for ep, t0 in enumerate(range(0, num_steps, L)):
        seg = min(L, num_steps - t0)
        traj = episode_loop(
            graphs, partial(_episode_steps, params, step_row_fn, policy,
                            policy_params, seg, generator),
            state, obs, generator=generator, clone=t0 + seg < num_steps)
        if seg == L:
            state, ts = start(ep + 1)
            obs = ts.obs
            _set_last(traj.obs, obs)
        parts.append(traj)
    return join_episodes(parts)


def _episode_steps(params, step_row_fn, policy, policy_params, seg: int,
                   generator, state, obs) -> TimeStep:
    """``seg`` steps of a lockstep episode from its reset ``state`` and
    ``obs``: the part of :func:`lockstep_unroll` that a CUDA graph
    captures."""
    traj = []
    for t in range(seg):
        action = policy(policy_params, obs, generator)
        state, ts = step_row_fn(params, state, action,
                                params.step_table[state.day, t])
        obs = ts.obs
        traj.append(ts)
    return tree_stack(traj)


class EVChargingEnv(FunctionalEnv[EVParams, EVState]):
    name = "evcharging"

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def day_from_seed(params: EVParams, seed: int) -> int:
        """seed -> episode day: ``seed % n_days``, the sequential days of
        the JAX package's ``EVChargingEnv.day_from_seed``."""
        return seed % params.n_days

    # ---- batched API ----------------------------------------------------
    def reset(self, params: EVParams, generator: torch.Generator,
              batch: int) -> tuple[EVState, TimeStep]:
        """``batch`` envs on uniform days drawn from ``generator``."""
        day = draw_env_rows(lambda b: torch.randint(
            params.n_days, (b,), generator=generator,
            device=generator.device), batch)
        return self.reset_at_day(params, day)

    def reset_at_day(self, params: EVParams, day) -> tuple[EVState, TimeStep]:
        dev = params.device
        day = torch.as_tensor(day, dtype=torch.long, device=dev).reshape(-1)
        B, n = day.shape[0], params.n_stations
        state = EVState(
            day=day,
            t=torch.zeros(B, dtype=torch.long, device=dev),
            plugged=torch.zeros((B, n), dtype=torch.bool, device=dev),
            dep=torch.zeros((B, n), dtype=torch.long, device=dev),
            est_dep=torch.zeros((B, n), dtype=torch.long, device=dev),
            demand=torch.zeros((B, n), dtype=torch.float32, device=dev))
        zero = torch.zeros(B, dtype=torch.float32, device=dev)
        ts = TimeStep(
            obs=self._obs(params, state), reward=zero,
            terminated=torch.zeros(B, dtype=torch.bool, device=dev),
            truncated=torch.zeros(B, dtype=torch.bool, device=dev),
            info=self._info(params, state, zero, zero, zero))
        return state, ts

    def step(self, params: EVParams, state: EVState, action: torch.Tensor,
             generator: torch.Generator | None = None
             ) -> tuple[EVState, TimeStep]:
        """One step of every env; ``action`` is (B, n) in [0, 1]. The step
        draws nothing: ``generator`` is accepted for the env protocol."""
        return self._step_row(params, state, action,
                              params.step_table[state.day, state.t])

    def _step_row(self, params: EVParams, state: EVState, action, row
                  ) -> tuple[EVState, TimeStep]:
        """The step given the envs' (day, t) table rows (B, W): shared by
        :meth:`step` and :meth:`batch_unroll`'s episode loop."""
        action = torch.as_tensor(action, dtype=torch.float32,
                                 device=params.device)
        new_state, reward, terms = advance(params, state, action, row)
        ts = TimeStep(
            obs=self._obs(params, new_state), reward=reward,
            terminated=new_state.t >= MAX_TIMESTEP,
            truncated=torch.zeros_like(new_state.t, dtype=torch.bool),
            info=self._info(params, state, terms["profit"],
                            terms["carbon_cost"], terms["excess_charge"]))
        return new_state, ts

    def episode_steps(self, params: EVParams) -> int:
        return MAX_TIMESTEP

    # ---- lockstep episode loop -------------------------------------------
    def batch_unroll(self, params: EVParams, policy, policy_params,
                     batch: int, num_steps: int,
                     generator: torch.Generator | None = None, days=None,
                     graphs=None) -> TimeStep:
        """Lockstep rollout of ``batch`` envs under ``policy(policy_params,
        obs, generator) -> (B, n) actions``: every env's step t reads its
        row ``step_table[day, t]`` directly. At each episode boundary the
        last step's obs is the next episode's reset obs (autoreset). Reset
        days are drawn by :meth:`reset` from ``generator`` in the order
        :func:`core.batch_rollout`'s autoreset path draws them (the whole
        batch ends an episode at once), or prescribed by ``days``
        ((num_steps // 288 + 1, B)).

        Each episode's step loop is one replay of a CUDA graph in
        ``graphs`` when given (:func:`core.rollout.episode_loop`), which
        the result then holds until the graph's next replay. The loop,
        :func:`lockstep_unroll`, is shared with the multi-agent view."""
        return lockstep_unroll(
            params, partial(self.reset, params),
            partial(self.reset_at_day, params), self._step_row, policy,
            policy_params, batch, num_steps, generator=generator, days=days,
            graphs=graphs)

    # ---- whole-episode kernels -------------------------------------------
    @staticmethod
    def _episode_days(params: EVParams, batch: int, episodes: int, days,
                      generator) -> torch.Tensor:
        """(episodes, batch) reset days: ``days`` as given ((batch,) for one
        episode), else uniform draws from ``generator``."""
        if days is None:
            if generator is None:
                raise ValueError("pass reset `days` or a torch.Generator")
            days = draw_env_rows(lambda b: torch.randint(
                params.n_days, (episodes, b), generator=generator,
                device=generator.device), batch, axis=1)
        days = torch.as_tensor(days, dtype=torch.long,
                               device=params.device).reshape(-1, batch)
        if days.shape[0] != episodes:
            raise ValueError(f"need reset days for {episodes} episodes, "
                             f"got {days.shape[0]}")
        return days

    def fused_rollout(self, params: EVParams, batch: int, num_steps: int,
                      days=None, generator: torch.Generator | None = None,
                      actions: torch.Tensor | None = None) -> TimeStep:
        """Simulation tier: whole episodes in one kernel launch per episode
        (``ops/cuda/ev_rollout.py::ev_segment``), station state in
        registers, with either projection operator and any day bank.
        Returns rewards + info per step; ``obs`` is an empty dict.

        ``days``: (episodes, batch) or (batch,) reset days, else drawn from
        ``generator``. ``actions``: (num_steps, batch, n) prescribed
        actions; if None the kernel draws U[0, 1) actions from a Philox
        stream seeded from ``generator``."""
        from ...ops.cuda.ev_rollout import ev_segment

        L = MAX_TIMESTEP
        episodes = -(-num_steps // L)
        parts = []
        for ep in range(episodes):
            with trace.span("ev.fused_rollout", params.device):
                trace.begin("ev.prelaunch")     # ended by ev_segment
                if ep == 0:
                    days = self._episode_days(params, batch, episodes, days,
                                              generator)
                t0 = ep * L
                seg = min(L, num_steps - t0)
                if actions is None:
                    acts, seed = None, kernel_seed(generator)
                else:
                    acts, seed = actions[t0:t0 + seg], 0
                out, _ = ev_segment(params, days[ep], seg, actions=acts,
                                    seed=seed)
                done = torch.zeros((seg, batch), dtype=torch.bool,
                                   device=params.device)
                if seg == L:
                    done[-1] = True
                parts.append(TimeStep(
                    obs={}, reward=out[..., 0], terminated=done,
                    truncated=torch.zeros_like(done),
                    info={"profit": out[..., 1], "carbon_cost": out[..., 2],
                          "excess_charge": out[..., 3],
                          "max_profit": params.day_max_profit[
                              days[ep]].expand(seg, batch),
                          "num_evs": params.day_num_evs[days[ep]].expand(
                              seg, batch)}))
        if len(parts) == 1:
            return parts[0]
        return TimeStep(
            obs={}, reward=torch.cat([p.reward for p in parts]),
            terminated=torch.cat([p.terminated for p in parts]),
            truncated=torch.cat([p.truncated for p in parts]),
            info={k: torch.cat([p.info[k] for p in parts])
                  for k in parts[0].info})

    def fused_layout(self, params: EVParams) -> dict:
        """Learner-block layout of :meth:`fused_policy_unroll`."""
        from ...ops.cuda.ev_rollout import ev_fused_layout
        return ev_fused_layout(params.n_stations, params.moer_forecast_steps)

    def fused_policy_unroll_supported(self, params: EVParams,
                                      batch: int) -> bool:
        """The policy kernel computes every batch with the dual-FISTA
        operator, and has no ADMM branch (nor has the JAX package's)."""
        return not isinstance(params.proj, qp.SOCProjection)

    def fused_policy_unroll(self, params: EVParams, policy, batch: int,
                            num_steps: int, days=None,
                            generator: torch.Generator | None = None,
                            noise: torch.Tensor | None = None) -> dict:
        """PPO rollout with the actor inside the episode kernel
        (``ops/cuda/ev_rollout.py::ev_policy_segment``): obs assembly, the
        2-layer tanh actor in bf16, Gaussian sampling, tanh squash to
        Box(0, 1), projection and env step. ``policy`` is a
        ``parallel.ppo.ActorCritic``; ``num_steps`` is a multiple of 288.

        Returns ``lrn`` (T, B, obs_dim + n) bf16 — the obs the policy saw in
        canonical flat order, then the pre-squash draws u (see
        :meth:`fused_layout`) — plus ``reward``/``done``/info (T, B) and
        the reset ``days`` (episodes, B). ``noise`` (T, B, n) prescribes
        the normal draws; otherwise the kernel draws Box–Muller normals
        from a Philox stream seeded from ``generator``, keyed by the global
        env index (``core.env_offset`` under a data-parallel mesh)."""
        from ...ops.cuda.ev_rollout import (ev_policy_segment,
                                            pack_policy_weights)

        L = MAX_TIMESTEP
        if num_steps % L != 0:
            raise ValueError(f"num_steps must be a multiple of {L}")
        episodes = num_steps // L
        outs, lrns = [], []
        for ep in range(episodes):
            with trace.span("ev.fused_rollout", params.device):
                trace.begin("ev.prelaunch")     # ended by ev_policy_segment
                if ep == 0:
                    days = self._episode_days(params, batch, episodes, days,
                                              generator)
                    weights = pack_policy_weights(policy)
                if noise is None:
                    nz, seed = None, kernel_seed(generator)
                else:
                    nz, seed = noise[ep * L:(ep + 1) * L], 0
                out, lrn = ev_policy_segment(params, weights, days[ep], L,
                                             noise=nz, seed=seed,
                                             env_offset=env_offset())
                outs.append(out)
                lrns.append(lrn)
        out = torch.cat(outs)
        done = torch.zeros((num_steps, batch), dtype=torch.bool,
                           device=params.device)
        done[L - 1::L] = True
        return {"lrn": torch.cat(lrns), "reward": out[..., 0], "done": done,
                "profit": out[..., 1], "carbon_cost": out[..., 2],
                "excess_charge": out[..., 3], "days": days}

    # ---- obs/info -------------------------------------------------------
    def _obs(self, params: EVParams, state: EVState) -> dict:
        t = state.t
        k = params.moer_forecast_steps
        est = torch.where(state.plugged,
                          (state.est_dep - t[:, None]).float(), 0.0)
        demands = torch.where(state.plugged, state.demand, 0.0)
        moer_row = params.moer[state.day, t]
        return {
            "timestep": (t.float() / MAX_TIMESTEP)[:, None],
            "est_departures": est,
            "demands": demands,
            "prev_moer": moer_row[:, 0:1],
            "forecasted_moer": moer_row[:, 1:1 + k],
        }

    def _info(self, params: EVParams, state: EVState, profit, carbon,
              excess) -> dict:
        return {
            "profit": profit,
            "carbon_cost": carbon,
            "excess_charge": excess,
            "max_profit": params.day_max_profit[state.day],
            "num_evs": params.day_num_evs[state.day],
        }

    # ---- metadata -------------------------------------------------------
    def observation_space(self, params: EVParams) -> DictSpace:
        n = params.n_stations
        return DictSpace({
            "timestep": Box(0, 1, (1,)),
            "est_departures": Box(-288, 288, (n,)),
            "demands": Box(0, 100, (n,)),
            "prev_moer": Box(0, 1, (1,)),
            "forecasted_moer": Box(0, 1, (params.moer_forecast_steps,)),
        })

    def action_space(self, params: EVParams) -> Box:
        return Box(0.0, 1.0, (params.n_stations,))
