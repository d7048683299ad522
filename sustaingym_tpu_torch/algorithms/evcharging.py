"""EV-charging baselines: greedy, random, MPC and offline-optimal.

The port of ``sustaingym_tpu.algorithms.evcharging`` (the reference's
algorithms/evcharging/baselines.py with its cvxpy + MOSEK solves replaced
by fixed-iteration PDHG):

- MPC: each step an LP over the lookahead window (profit - carbon
  objective, demand and network rows), solved by ``ops/lp.py::solve_lp``
  on the params' device. The network's magnitude constraint |C_k x| <= r_k
  is outer-approximated by J tangent cuts a row (cos(pi / J) tight: < 2%
  at J = 16). The LP has one-sided G rows, so it does not take the
  paired-form solve kernel, as in the JAX package;
- offline-optimal: the full-horizon (288-step) LP over the day's true
  sessions, solved once an episode by a structured PDHG that works on the
  per-step blocks (no dense (T n) x (T n) system).

The day's sessions are read back from the params' step table (arrival
step, station, departure and requested energy of each plug-in), the rows
the env itself simulates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.evcharging.env import (A_PERS_TO_KWH, ACTION_SCALE_FACTOR,
                                   CARBON_COST_FACTOR, MAX_TIMESTEP,
                                   PROFIT_FACTOR, EVParams)
from ..ops import lp
from .base import BaseAlgorithm

__all__ = ["GreedyAlgorithm", "RandomAlgorithm", "MPC", "OfflineOptimal",
           "offline_optimal_schedule", "day_sessions"]

MAX_ACTION = 1.0
D_MAX_ACTION = 4  # the discrete action wrapper's largest bin


def _continuous(env) -> bool:
    import gymnasium
    return isinstance(env.action_space, gymnasium.spaces.Box)


class GreedyAlgorithm(BaseAlgorithm):
    """The largest pilot wherever a demand is left."""

    def __init__(self, env):
        super().__init__(env)
        self.continuous = _continuous(env)
        self.max_action = MAX_ACTION if self.continuous else D_MAX_ACTION

    def get_action(self, observation):
        return np.where(observation["demands"] > 0, self.max_action, 0
                        ).astype(np.float32)


class RandomAlgorithm(BaseAlgorithm):
    """Uniform-random pilots."""

    def __init__(self, env):
        super().__init__(env)
        self.continuous = _continuous(env)
        self.rng = np.random.default_rng()

    def get_action(self, observation):
        n = observation["demands"].shape[-1]
        if self.continuous:
            return self.rng.random(n).astype(np.float32)
        return self.rng.choice(D_MAX_ACTION + 1, size=n).astype(np.float32)


def _tangent_rows(params: EVParams, n_tangents: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Polyhedral outer approximation of ||C_k x|| <= r_k: for angles
    theta_j, cos(theta_j) Re_k x + sin(theta_j) Im_k x <= r_k."""
    re = params.constraint_re.cpu().numpy()
    im = params.constraint_im.cpu().numpy()
    r = params.magnitudes.cpu().numpy() / ACTION_SCALE_FACTOR
    rows, rhs = [], []
    for j in range(n_tangents):
        th = 2 * np.pi * j / n_tangents
        rows.append(np.cos(th) * re + np.sin(th) * im)
        rhs.append(r)
    return np.vstack(rows), np.concatenate(rhs)


class MPC(BaseAlgorithm):
    """Each step, maximizes profit - carbon over the next ``lookahead``
    steps and applies the first step's pilots."""

    def __init__(self, env, lookahead: int = 12, n_tangents: int = 16,
                 lp_iters: int = 600):
        super().__init__(env)
        params: EVParams = env.params
        self.params = params
        self.L = lookahead
        assert lookahead <= params.moer_forecast_steps
        n = params.n_stations
        tan, tan_rhs = _tangent_rows(params, n_tangents)
        m_tan = tan.shape[0]
        # variable layout x[t * n + i]; rows: the demand coupling
        # sum_t x[t, i] <= demand_i / (A_PERS * 32), then each step's
        # network tangents
        G_rows = [np.tile(np.eye(n), (1, lookahead))]
        for t in range(lookahead):
            blk = np.zeros((m_tan, n * lookahead))
            blk[:, t * n:(t + 1) * n] = tan
            G_rows.append(blk)
        dev = params.device
        self.op = lp.make_lp_operator(np.zeros((0, n * lookahead)),
                                      np.vstack(G_rows), iters=lp_iters,
                                      device=dev)
        self._tan_rhs = torch.as_tensor(np.tile(tan_rhs, lookahead),
                                        dtype=torch.float32, device=dev)
        self.n = n

    def _solve(self, demands: torch.Tensor, moers: torch.Tensor,
               est_dep: torch.Tensor) -> torch.Tensor:
        """The first step's pilots (n,) of the lookahead LP for one env's
        ``demands`` (n,), MOER forecast (L,) and estimated departures (n,):
        charging allowed until the estimated departure."""
        L, n, dev = self.L, self.n, self.params.device
        cur = torch.where(demands > 0, torch.clamp_min(est_dep, 1.0),
                          torch.zeros_like(est_dep))
        tgrid = torch.arange(L, device=dev)[:, None]
        mask = (tgrid < cur[None, :]).to(torch.float32)        # (L, n)
        c = ACTION_SCALE_FACTOR * (CARBON_COST_FACTOR * moers[:, None]
                                   - PROFIT_FACTOR) * torch.ones(
            (L, n), dtype=torch.float32, device=dev)
        c = (c * mask).reshape(-1)
        # the LP's argmin does not change with a positive scale of c; a
        # unit scale keeps PDHG's objective step commensurate with the
        # unit-scale constraint rows
        c = c / (c.abs().max() + 1e-12)
        ub = mask.reshape(-1)
        h = torch.cat([demands / A_PERS_TO_KWH / ACTION_SCALE_FACTOR,
                       self._tan_rhs])
        sol = lp.solve_lp(self.op, c[None], c.new_zeros((1, 0)), h[None],
                          torch.zeros_like(ub)[None], ub[None])
        return sol.x.reshape(L, n)[0]

    def get_action(self, observation):
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=self.params.device)
        return self._solve(t(observation["demands"]),
                           t(observation["forecasted_moer"][:self.L]),
                           t(observation["est_departures"])).cpu().numpy()


def day_sessions(params: EVParams, day: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The sessions of ``day`` as the params' step table holds them, one a
    plug-in: (arrival step, station, departure step, requested kWh),
    ordered by arrival then station."""
    n = params.n_stations
    table = params.step_table[day].cpu().numpy()       # (289, 3n + 39)
    dep, req = table[:, :n], table[:, 2 * n:3 * n]
    arr, st = np.nonzero(dep > 0)
    return arr, st, dep[arr, st], req[arr, st]


def offline_optimal_schedule(params: EVParams, day: int,
                             n_tangents: int = 16, iters: int = 3000
                             ) -> torch.Tensor:
    """The full-horizon LP of ``day`` with its true arrivals and departures,
    solved by a structured PDHG on the params' device; returns (288, n)
    pilots in [0, 1]."""
    n, T, dev = params.n_stations, MAX_TIMESTEP, params.device
    arr, st, dep, req = day_sessions(params, day)
    n_ev = arr.shape[0]

    # each session's charge window (arrival .. departure - 1), its station
    # one-hot and its requested energy in A-periods
    tgrid = np.arange(T)[None, :]
    win = ((tgrid >= arr[:, None]) & (tgrid < dep[:, None])
           ).astype(np.float32)                         # (n_ev, T)
    S = np.zeros((n_ev, n), np.float32)
    S[np.arange(n_ev), st] = 1.0
    q = req / A_PERS_TO_KWH / ACTION_SCALE_FACTOR

    # station-time availability: the union of the station's windows
    xmask = np.minimum(np.einsum("et,ei->ti", win, S), 1.0
                       ).astype(np.float32)             # (T, n)
    tan, tan_rhs = _tangent_rows(params, n_tangents)    # (mJ, n), (mJ,)
    moer = params.moer[day, 1:T + 1, 0].cpu().numpy()
    c = (ACTION_SCALE_FACTOR
         * (CARBON_COST_FACTOR * moer[:, None] - PROFIT_FACTOR)
         * np.ones((T, n), np.float32))
    c = c / (np.max(np.abs(c)) + 1e-12)

    # PDHG steps: row / column sums of the structured operator
    col_sum = np.abs(tan).sum(axis=0)[None, :] + np.einsum("et,ei->ti",
                                                           win, S)
    tau = 1.0 / np.maximum(col_sum, 1e-6)
    sig_tan = 1.0 / np.maximum(np.abs(tan).sum(axis=1), 1e-6)
    sig_dem = 1.0 / np.maximum(win.sum(1) * S.sum(1), 1e-6)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    tan_t, win_t, S_t, c_t = f32(tan), f32(win), f32(S), f32(c)
    ub, tau_t = f32(xmask), f32(tau)
    sig_tan_t, sig_dem_t = f32(sig_tan), f32(sig_dem)
    tan_rhs_t, q_t = f32(tan_rhs), f32(q)
    tan_T, S_T = tan_t.T.contiguous(), S_t.T.contiguous()

    x = torch.zeros((T, n), dtype=torch.float32, device=dev)
    z = torch.zeros((T, tan_t.shape[0]), dtype=torch.float32, device=dev)
    w = torch.zeros((n_ev,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        # the adjoint: tangent rows z (T, mJ) @ tan, and the sessions'
        grad = c_t + z @ tan_t + (win_t * w[:, None]).T @ S_t
        x_new = torch.minimum(torch.maximum(x - tau_t * grad, zero), ub)
        xb = 2 * x_new - x
        z = torch.clamp_min(z + sig_tan_t * (xb @ tan_T - tan_rhs_t), 0.0)
        # session e's energy: sum_t win[e, t] x[t, station_e]
        sess = torch.sum((xb @ S_T).T * win_t, dim=1)
        w = torch.clamp_min(w + sig_dem_t * (sess - q_t), 0.0)
        x = x_new
    return x


class OfflineOptimal(BaseAlgorithm):
    """Replays the episode day's precomputed full-horizon schedule."""

    def __init__(self, env, n_tangents: int = 16, iters: int = 3000):
        super().__init__(env)
        self.n_tangents = n_tangents
        self.iters = iters
        self._traj: np.ndarray | None = None
        self._t = 0

    def reset(self) -> None:
        day = int(self.env._state.day[0])
        self._traj = offline_optimal_schedule(
            self.env.params, day, self.n_tangents, self.iters).cpu().numpy()
        self._t = 0

    def get_action(self, observation):
        a = self._traj[min(self._t, MAX_TIMESTEP - 1)]
        self._t += 1
        return a
