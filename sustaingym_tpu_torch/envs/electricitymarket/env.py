"""ElectricityMarketEnv in PyTorch — battery bidding into a 5-minute SCED
market.

The port of ``sustaingym_tpu.envs.electricitymarket.env``, with the batch
axis written out (every state tensor is (B, ...)):

- the 24-bus IEEE RTS-24 network (``network.py``) with 33 generators
  bidding true cost and one 80 MWh battery, the agent, which bids
  charge/discharge prices for the next ``horizon`` settlement intervals;
- every step the market operator clears a multi-interval SCED LP by PDHG
  (``ops/lp.py``): the clearing price is minus the dual of the first
  power-balance row, the battery dispatch its charge/discharge variables;
  the episode's first solve runs the cold budget (``op.iters``), later
  solves start from the previous solution shifted one interval and run
  ``lp_warm_iters``;
- reward p x + P_CO2 m x - (terminal state-of-charge penalty), optionally
  deferred to the last step; ``discrete=True`` maps Discrete(3) actions
  (charge / do nothing / discharge) to :data:`DISCRETE_BIDS`.

The day's load and MOER rows are read by direct indexing,
``load[day, t:t+k]`` and ``moer[day, t, :k+1]``: the JAX package's rolled
state slabs are a TPU workaround. On the card, when the operator has
exactly the kernel's math, every solve is one launch of the whole-solve
CUDA kernel (``ops/cuda/lp_solve.py``): each lockstep step of
:meth:`ElectricityMarketEnv.batch_unroll` with one budget, and each
generic :meth:`ElectricityMarketEnv.step` with the per-env budgets on the
device, so that a CUDA graph captures it.
"""
from __future__ import annotations

import datetime as dt
from functools import partial
from typing import Any

import numpy as np
import torch

from ...core import (Box, DictSpace, Discrete, FunctionalEnv, TimeStep,
                     dataclass, draw_env_rows, replace, resolve_device,
                     tree_stack)
from ...core import trace
from ...core.graph import device_const
from ...core.rollout import episode_loop, join_episodes
from ...ops import lp
from . import network as net_mod
from .network import (BATTERY_CAPACITY_MWH, BATTERY_EFFICIENCY,
                      BATTERY_POWER_MW, build_network, build_sced_matrices)

T_STEPS = 288
TAU_H = 1.0 / 12.0
P_CO2 = 30.85 / 1000.0     # $/kg CO2 (the EV env's carbon price)
MAX_BID = 1000.0           # $/MWh cap on battery bids

# 3-action discretization (charge / do nothing / discharge) as
# (charge_bid, discharge_bid) pairs
DISCRETE_BIDS = ((MAX_BID, MAX_BID),   # 0: charge
                 (0.0, MAX_BID),       # 1: do nothing
                 (0.0, 0.0))           # 2: discharge


@dataclass
class MarketParams:
    # static SCED structure
    op: lp.LPOperator
    ub: torch.Tensor              # (n,) variable upper bounds
    gen_cost_tiled: torch.Tensor  # (n_gen * k,)
    line_rating: torch.Tensor     # (nl,)
    load_sf: torch.Tensor         # (nl,) PTDF @ load distribution
    # data
    load: torch.Tensor            # (n_days, 289 + k) MW system load (padded)
    moer: torch.Tensor            # (n_days, 289, 37) kg CO2 / kWh
    # warm-start shift permutations: each step moves the SCED horizon one
    # interval, so the previous solution's per-interval blocks shift
    # tau+1 -> tau (last block duplicated)
    warm_perm_x: torch.Tensor     # (n,) int64
    warm_perm_y: torch.Tensor     # (me,) int64
    warm_perm_z: torch.Tensor     # (mi,) int64
    n_gen: int
    n_lines: int
    horizon: int
    n_days: int
    ic: int
    id: int
    intermediate_rewards: bool = True
    lp_warm_iters: int = 40       # warm budget (op.iters is the cold one)
    discrete: bool = False
    # the solve kernel's packed operator (ops/cuda/lp_solve.py::
    # PDHGOperands), made once on the card when the operator has the
    # kernel's math; None on the CPU
    kops: Any = None

    @property
    def device(self) -> torch.device:
        return self.load.device


@dataclass
class MarketState:
    day: torch.Tensor            # (B,) int64
    t: torch.Tensor              # (B,) int64
    energy: torch.Tensor         # (B,) MWh in the battery
    energy0: torch.Tensor        # (B,) initial MWh (terminal penalty target)
    prev_action: torch.Tensor    # (B, 2k)
    prev_dispatch: torch.Tensor  # (B,)
    prev_price: torch.Tensor     # (B,)
    prev_load: torch.Tensor      # (B,) l_{t-1}: demand cleared last step
    cum_reward: torch.Tensor     # (B,)
    price_sum: torch.Tensor      # (B,) running sum for the terminal price
    warm_x: torch.Tensor         # (B, n) the last solve's solution
    warm_y: torch.Tensor         # (B, me)
    warm_z: torch.Tensor         # (B, mi)


def _synthesize_load(n_days: int, month: int, seed: int = 7) -> np.ndarray:
    """Deterministic CAISO-like system load at 5-minute resolution; the JAX
    package's ``default_rng(seed + month)`` stream, draw for draw."""
    rng = np.random.default_rng(seed + month)
    steps = T_STEPS + 1
    t = np.arange(steps) / T_STEPS
    season = 1.0 + 0.12 * np.cos(2 * np.pi * (month - 7.5) / 12.0)
    out = np.empty((n_days, steps))
    for d in range(n_days):
        base = (0.62 - 0.10 * np.cos(2 * np.pi * (t - 0.08))
                + 0.16 * np.exp(-0.5 * ((t - 0.79) / 0.09) ** 2)   # evening pk
                + 0.05 * np.exp(-0.5 * ((t - 0.5) / 0.2) ** 2))
        ar = rng.normal(scale=0.004, size=steps).cumsum()
        out[d] = net_mod.PEAK_LOAD_MW * np.clip(
            season * (base + 0.03 * rng.normal() + ar), 0.35, 0.95)
    return out


def make_params(month: str = "2021-05", horizon: int = 4,
                lp_iters: int = 200, lp_warm_iters: int = 40,
                intermediate_rewards: bool = True, discrete: bool = False,
                moer_ba: str = "SGIP_CAISO_PGE",
                lp_bf16: bool | None = None, lp_relax: float = 1.0,
                lp_precond_alpha: float = 0.35, lp_merge: bool = False,
                device="cuda") -> MarketParams:
    """The market of ``month`` on ``device`` (the card unless the caller
    asks for the CPU), with the JAX package's defaults: cold budget
    ``lp_iters`` 200, warm budget 40, preconditioner exponent 0.35.

    ``lp_bf16`` rounds the PDHG matrix-product operands to bf16 (float32
    sums); None resolves to True on the card, where every solve then runs
    the whole-solve kernel on the operator packed here (``kops``), and
    False on the CPU (the JAX package resolves it to "on the TPU")."""
    from ...data.ev_etl import build_moer_pack

    device = resolve_device(device)
    if lp_bf16 is None:
        lp_bf16 = device.type == "cuda"
    y, m = (int(s) for s in month.split("-"))
    first = dt.date(y, m, 1)
    last = (dt.date(y + 1, 1, 1) if m == 12 else dt.date(y, m + 1, 1)) \
        - dt.timedelta(days=1)
    moer = build_moer_pack((first.isoformat(), last.isoformat()), ba=moer_ba)
    n_days = moer.shape[0]

    net = build_network()
    mats = build_sced_matrices(net, horizon)
    # flow and energy limits are all +/- pairs of the S block
    op = lp.make_lp_operator(
        mats["A"], np.zeros((0, mats["A"].shape[1])), iters=lp_iters,
        sym=mats["S"], matmul_dtype=torch.bfloat16 if lp_bf16 else None,
        relax=lp_relax, precond_alpha=lp_precond_alpha,
        merge_blocks=lp_merge, device=device)
    load = _synthesize_load(n_days, m)
    # pad horizon steps with the head of the next day for lookahead
    load = np.concatenate([load, np.roll(load, -1, axis=0)[:, :horizon]], 1)

    # horizon-shift permutations (variable layout of build_sced_matrices:
    # x = [g(n_gen) per tau | c(k) | d(k)], y = per-tau balance, z half =
    # [per-tau flow blocks (nl each) | k energy rows])
    k, ng, nl = horizon, net.n_gen, net.n_lines
    nxt = np.minimum(np.arange(k) + 1, k - 1)
    perm_x = np.concatenate([
        (nxt[:, None] * ng + np.arange(ng)[None, :]).reshape(-1),
        mats["ic"] + nxt, mats["id"] + nxt])
    half = np.concatenate([
        (nxt[:, None] * nl + np.arange(nl)[None, :]).reshape(-1),
        k * nl + nxt])
    perm_z = np.concatenate([half, half + op.ms])

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device).contiguous()

    def idx(x):
        return torch.as_tensor(x, dtype=torch.long, device=device)

    params = MarketParams(
        op=op, ub=f32(mats["ub"]),
        gen_cost_tiled=f32(np.tile(net.gen_cost, horizon)),
        line_rating=f32(net.line_rating), load_sf=f32(mats["load_sf"]),
        load=f32(load), moer=f32(moer), warm_perm_x=idx(perm_x),
        warm_perm_y=idx(nxt), warm_perm_z=idx(perm_z),
        n_gen=net.n_gen, n_lines=net.n_lines, horizon=horizon,
        n_days=n_days, ic=int(mats["ic"]), id=int(mats["id"]),
        intermediate_rewards=bool(intermediate_rewards),
        lp_warm_iters=int(lp_warm_iters), discrete=bool(discrete))
    if device.type == "cuda" and uses_solve_kernel(params):
        from ...ops.cuda.lp_solve import pack_pdhg_operands
        params = replace(params, kops=pack_pdhg_operands(op))
    return params


def uses_solve_kernel(params: MarketParams) -> bool:
    """Whether the solves run through ``pdhg_solve_paired``: only for an
    operator with exactly the kernel's math (no G rows, relax 1, bf16
    products), as in the JAX package; any other configuration runs
    ``solve_lp``. :meth:`ElectricityMarketEnv.step` takes the kernel on
    the card only (on the CPU it keeps ``solve_lp``'s per-env loop)."""
    op = params.op
    return (op.mg == 0 and op.relax == 1.0
            and op.matmul_dtype == torch.bfloat16)


def kernel_solve(params: MarketParams, kops, c, b, h, init: lp.LPSolution,
                 iters) -> lp.LPSolution:
    """One ``pdhg_solve_paired`` call on the packed operator ``kops``:
    the SCED problem in ``solve_lp``'s layout (h and z as [plus, minus])
    split into the kernel's operands; ``iters`` an int or (B,) int32
    per-env budgets."""
    from ...ops.cuda.lp_solve import pdhg_solve_paired
    ms = params.op.ms
    x, y, zp, zm = pdhg_solve_paired(
        kops, c, b, h[:, :ms].contiguous(), h[:, ms:].contiguous(),
        params.ub, init.x, init.y, init.z[:, :ms].contiguous(),
        init.z[:, ms:].contiguous(), iters)
    return lp.LPSolution(x=x, y=y, z=torch.cat([zp, zm], -1))


class ElectricityMarketEnv(FunctionalEnv[MarketParams, MarketState]):
    name = "electricitymarket"

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def day_from_seed(params: MarketParams, seed: int) -> int:
        """seed -> episode day: ``seed % n_days``."""
        return seed % params.n_days

    def reset(self, params: MarketParams, generator: torch.Generator,
              batch: int) -> tuple[MarketState, TimeStep]:
        """``batch`` envs on days drawn uniformly from ``generator``."""
        day = draw_env_rows(lambda b: torch.randint(
            params.n_days, (b,), generator=generator,
            device=generator.device), batch)
        return self.reset_at_day(params, day)

    def reset_at_day(self, params: MarketParams, day
                     ) -> tuple[MarketState, TimeStep]:
        dev, op = params.device, params.op
        day = torch.as_tensor(day, dtype=torch.long, device=dev).reshape(-1)
        B = day.shape[0]

        def z(*shape):
            return torch.zeros((B,) + shape, dtype=torch.float32, device=dev)

        e0 = torch.full((B,), BATTERY_CAPACITY_MWH / 2.0, dtype=torch.float32,
                        device=dev)
        state = MarketState(
            day=day, t=torch.zeros_like(day), energy=e0, energy0=e0,
            prev_action=z(2 * params.horizon), prev_dispatch=z(),
            prev_price=z(), prev_load=z(), cum_reward=z(), price_sum=z(),
            warm_x=z(op.n), warm_y=z(op.me), warm_z=z(op.mi))
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        ts = TimeStep(obs=self._obs(params, state), reward=z(), terminated=no,
                      truncated=no, info=self._zero_info(B, dev))
        return state, ts

    def _loads(self, params: MarketParams, state: MarketState
               ) -> torch.Tensor:
        """(B, k) load forecast: the day's load at t .. t+k-1."""
        hours = state.t[:, None] + torch.arange(params.horizon,
                                                device=params.device)
        return params.load[state.day[:, None], hours]

    def _sced_problem(self, params: MarketParams, state: MarketState,
                      action: torch.Tensor):
        """Per-env SCED problem data (c, b, h, warm start, load now) for
        the current step."""
        k = params.horizon
        B = action.shape[0]
        c = torch.cat([params.gen_cost_tiled.expand(B, -1), -action[:, :k],
                       action[:, k:]], -1)
        loads = self._loads(params, state)
        # h = [h_plus(ms), h_minus(ms)], S rows = per-tau flow blocks then
        # per-tau energy rows: +S x <= h_plus, -S x <= h_minus
        base = params.load_sf * loads[:, :, None]              # (B, k, nl)
        flow_p = (params.line_rating + base).reshape(B, -1)
        flow_m = (params.line_rating - base).reshape(B, -1)
        e_room = (BATTERY_CAPACITY_MWH - state.energy)[:, None].expand(B, k)
        h = torch.cat([flow_p, e_room, flow_m,
                       state.energy[:, None].expand(B, k)], -1)
        # the carried solution shifted one interval (zeros at t = 0, so the
        # cold start is unchanged)
        init = lp.LPSolution(x=state.warm_x[:, params.warm_perm_x],
                             y=state.warm_y[:, params.warm_perm_y],
                             z=state.warm_z[:, params.warm_perm_z])
        return c, loads, h, init, loads[:, 0]

    def clear_market(self, params: MarketParams, state: MarketState,
                     action: torch.Tensor) -> dict:
        """Builds and solves the SCED LP of the current step: the cold
        budget for envs at an episode's first step, the warm budget for the
        others, in one batched solve (each env frozen after its own
        budget). With the packed operator (``params.kops``, on the card)
        the solve is one ``pdhg_solve_paired`` launch that reads the
        budgets on the device; otherwise ``solve_lp``."""
        c, b, h, init, load0 = self._sced_problem(params, state, action)
        iters = torch.where(state.t == 0, params.op.iters,
                            params.lp_warm_iters)
        if params.kops is not None:
            sol = kernel_solve(params, params.kops, c, b, h, init,
                               iters.to(torch.int32))
        else:
            sol = lp.solve_lp(params.op, c, b, h,
                              torch.zeros_like(params.ub), params.ub,
                              init=init, iters=iters,
                              max_iters=max(params.op.iters,
                                            params.lp_warm_iters))
        return self._cleared(params, sol, load0)

    @staticmethod
    def _cleared(params: MarketParams, sol: lp.LPSolution, load0) -> dict:
        return {"price": -sol.y[:, 0], "charge": sol.x[:, params.ic],
                "discharge": sol.x[:, params.id],
                "gen_dispatch": sol.x[:, :params.n_gen], "sol": sol,
                "load": load0}

    @staticmethod
    def _prep_action(params: MarketParams, action) -> torch.Tensor:
        """(B, 2k) bids: clipped to [0, MAX_BID], or, with ``discrete``,
        the Discrete(3) actions 0=charge / 1=idle / 2=discharge mapped to
        :data:`DISCRETE_BIDS`, each repeated over the horizon."""
        dev = params.device
        if params.discrete:
            idx = torch.as_tensor(action, device=dev).long().reshape(-1)
            bids = device_const(DISCRETE_BIDS, dev)[idx]          # (B, 2)
            # each bid repeated over the horizon, as repeat_interleave
            return bids[:, :, None].expand(-1, -1, params.horizon).reshape(
                idx.shape[0], -1)
        return torch.as_tensor(action, dtype=torch.float32,
                               device=dev).clamp(0.0, MAX_BID)

    def step(self, params: MarketParams, state: MarketState, action,
             generator: torch.Generator | None = None
             ) -> tuple[MarketState, TimeStep]:
        action = self._prep_action(params, action)
        cleared = self.clear_market(params, state, action)
        return self._apply_cleared(params, state, action, cleared)

    def _apply_cleared(self, params: MarketParams, state: MarketState,
                       action: torch.Tensor, cleared: dict
                       ) -> tuple[MarketState, TimeStep]:
        price = cleared["price"]
        c0, d0 = cleared["charge"], cleared["discharge"]
        dispatch_mwh = (d0 - c0) * TAU_H
        energy = torch.clamp(
            state.energy + (BATTERY_EFFICIENCY * c0 - d0 / BATTERY_EFFICIENCY)
            * TAU_H, 0.0, BATTERY_CAPACITY_MWH)
        moer_kg_mwh = params.moer[state.day, state.t, 0] * 1000.0
        revenue = price * dispatch_mwh
        carbon_value = P_CO2 * moer_kg_mwh * dispatch_mwh
        step_reward = revenue + carbon_value

        t_next = state.t + 1
        terminated = t_next >= T_STEPS
        price_sum = state.price_sum + price
        avg_price = price_sum / t_next.float()
        # terminal penalty: missing energy valued at twice the day's
        # average clearing price
        terminal_cost = torch.where(
            terminated,
            2.0 * avg_price * torch.clamp_min(state.energy0 - energy, 0.0),
            torch.zeros_like(energy))
        step_reward = step_reward - terminal_cost
        cum = state.cum_reward + step_reward
        if params.intermediate_rewards:
            reward = step_reward
        else:
            reward = torch.where(terminated, cum, torch.zeros_like(cum))

        sol = cleared["sol"]
        new_state = MarketState(
            day=state.day, t=t_next, energy=energy, energy0=state.energy0,
            prev_action=action, prev_dispatch=dispatch_mwh, prev_price=price,
            prev_load=cleared["load"], cum_reward=cum, price_sum=price_sum,
            warm_x=sol.x, warm_y=sol.y, warm_z=sol.z)
        return new_state, TimeStep(
            obs=self._obs(params, new_state), reward=reward,
            terminated=terminated, truncated=torch.zeros_like(terminated),
            info={"price": price, "dispatch_mwh": dispatch_mwh,
                  "energy_level": energy, "revenue": revenue,
                  "carbon_value": carbon_value,
                  "terminal_cost": terminal_cost})

    # ---- lockstep episode path ---------------------------------------------
    def _episode_start(self, params: MarketParams, ep: int, batch: int,
                       generator, days) -> tuple[MarketState, TimeStep]:
        """Reset state and obs of episode ``ep``: days prescribed by
        ``days`` (episodes, B), else drawn by :meth:`reset`."""
        if days is None:
            return self.reset(params, generator, batch)
        days = torch.as_tensor(days, dtype=torch.long).reshape(-1, batch)
        if ep >= days.shape[0]:
            raise ValueError(f"need reset days for {ep + 1} episodes, got "
                             f"{days.shape[0]}")
        return self.reset_at_day(params, days[ep])

    def batch_unroll(self, params: MarketParams, policy, policy_params,
                     batch: int, num_steps: int,
                     generator: torch.Generator | None = None,
                     days=None, graphs=None) -> TimeStep:
        """Lockstep rollout: every env is at the same episode step, so the
        solve's budget is fixed by position, cold at an episode's first
        step and warm after, and one batched solve a step serves all envs.
        On an operator with the kernel's math (:func:`uses_solve_kernel`,
        the card's default) that solve is one launch of the whole-solve
        kernel ``pdhg_solve_paired``; otherwise it is ``solve_lp``, the same
        math as :meth:`step`. ``policy(policy_params, obs, generator)``
        returns (B, 2k) bids or, with ``discrete``, (B,) action indices. At
        each episode boundary the last step's obs is the next episode's
        reset obs (autoreset). Resets are drawn from ``generator`` in the
        order the generic autoreset path draws them, or prescribed by
        ``days`` ((num_steps // 288 + 1, B)).

        Each episode starts eagerly (the reset draws and the kernel's
        operands); its step loop (:meth:`_episode_steps`) is one replay of
        a CUDA graph in ``graphs`` when given
        (:func:`core.rollout.episode_loop`), solve launches included,
        which the result then holds until the graph's next replay.

        Traced (:mod:`core.trace`): each start is a ``market.start`` host
        span, each episode's step loop a ``market.episode`` device span,
        and each episode adds its solves and their PDHG iterations to
        ``market.solves`` and ``market.pdhg_iters``. Nothing on this path
        reads the card."""
        from ...ops.cuda.lp_solve import pack_pdhg_operands

        L = T_STEPS
        with trace.span("market.start"):
            kops = params.kops
            if kops is None and uses_solve_kernel(params):
                kops = pack_pdhg_operands(params.op)
            state, ts = self._episode_start(params, 0, batch, generator,
                                            days)
        obs, parts = ts.obs, []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            with trace.span("market.episode", params.device):
                traj = episode_loop(
                    graphs, partial(self._episode_steps, params, policy,
                                    policy_params, seg, generator),
                    state, obs, kops, generator=generator,
                    clone=t0 + seg < num_steps)
            # the lockstep budgets, known on the host: one solve a step
            trace.count("market.solves", seg)
            trace.count("market.pdhg_iters",
                        params.op.iters + (seg - 1) * params.lp_warm_iters)
            if seg == L:
                with trace.span("market.start"):
                    state, ts_r = self._episode_start(params, ep + 1, batch,
                                                      generator, days)
                    obs = ts_r.obs
                    for k, v in obs.items():
                        traj.obs[k][-1] = v
            parts.append(traj)
        return join_episodes(parts)

    def _episode_steps(self, params: MarketParams, policy, policy_params,
                       seg: int, generator, state: MarketState, obs,
                       kops) -> TimeStep:
        """``seg`` steps of an episode from ``state`` and its ``obs``, each
        solve through ``pdhg_solve_paired`` on ``kops`` (the packed
        operator) or, when it is None, through ``solve_lp``: the part of
        :meth:`batch_unroll` that a CUDA graph captures."""
        op = params.op
        lb = torch.zeros_like(params.ub)

        def solve(c, b, h, init, iters):
            if kops is None:
                return lp.solve_lp(op, c, b, h, lb, params.ub, init=init,
                                   iters=iters)
            return kernel_solve(params, kops, c, b, h, init, iters)

        traj = []
        for t in range(seg):
            actions = self._prep_action(
                params, policy(policy_params, obs, generator))
            c, b, h, init, load0 = self._sced_problem(params, state, actions)
            sol = solve(c, b, h, init,
                        op.iters if t == 0 else params.lp_warm_iters)
            state, ts = self._apply_cleared(
                params, state, actions, self._cleared(params, sol, load0))
            obs = ts.obs
            traj.append(ts)
        return tree_stack(traj)

    # ---- obs ------------------------------------------------------------
    def _obs(self, params: MarketParams, state: MarketState
             ) -> dict[str, torch.Tensor]:
        k = params.horizon
        moer_row = params.moer[state.day, state.t, :k + 1]     # (B, k + 1)
        return {
            "time": (state.t / T_STEPS).float()[:, None],
            "energy_level": state.energy[:, None],
            "prev_action": state.prev_action,
            "prev_dispatch": state.prev_dispatch[:, None],
            "prev_price": state.prev_price[:, None],
            "prev_load": state.prev_load[:, None],
            "load_forecast": self._loads(params, state),
            "prev_moer": moer_row[:, :1],
            "moer_forecast": moer_row[:, 1:],
        }

    @staticmethod
    def _zero_info(batch: int, device) -> dict[str, torch.Tensor]:
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        return {"price": z, "dispatch_mwh": z, "energy_level": z,
                "revenue": z, "carbon_value": z, "terminal_cost": z}

    # ---- metadata --------------------------------------------------------
    def episode_steps(self, params: MarketParams) -> int:
        """Fixed 288-step (5-minute) day."""
        return T_STEPS

    def observation_space(self, params: MarketParams) -> DictSpace:
        k = params.horizon
        return DictSpace({
            "time": Box(0, 1, (1,)),
            "energy_level": Box(0, BATTERY_CAPACITY_MWH, (1,)),
            "prev_action": Box(0, MAX_BID, (2 * k,)),
            "prev_dispatch": Box(-BATTERY_POWER_MW * TAU_H,
                                 BATTERY_POWER_MW * TAU_H, (1,)),
            "prev_price": Box(-MAX_BID, MAX_BID, (1,)),
            "prev_load": Box(0, 4000, (1,)),
            "load_forecast": Box(0, 4000, (k,)),
            "prev_moer": Box(0, 1, (1,)),
            "moer_forecast": Box(0, 1, (k,)),
        })

    def action_space(self, params: MarketParams):
        if params.discrete:
            return Discrete(3)
        return Box(0.0, MAX_BID, (2 * params.horizon,))
