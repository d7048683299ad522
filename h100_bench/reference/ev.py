"""Plain reference of the EV charging configuration: SustainGym's
EVChargingEnv at the Caltech ACN site, in float32 PyTorch.

It imports nothing of the program. It reads the same committed data packs
(session traces and MOER forecasts, by path), rebuilds the site's network
constraints, steps every env with the dual-FISTA projection, and draws
the random numbers the program documents for each device:

- on a CUDA card the episode kernels draw from a Philox4x32-10 stream
  keyed by the kernel seed and counted by (lane, step, env, stream); lane
  l holds stations l and l + 32. Stream 0 gives U[0, 1) actions (the
  simulation tier), stream 1 Box-Muller normals (the PPO rollout);
- on the CPU the program runs its plain versions, which draw from
  ``torch.Generator`` streams instead.

The kernel seed and the reset days come from the benchmark's own
generator, replayed from its saved state in the order the program draws
them: the days (one randint over the batch), then one 62-bit seed an
episode.

``prec`` selects the precision of the actor's operands ("bf16", the
configuration's, or "fp8", the control's) and of the projection's
products ("f32", the configuration's, or "tf32", the control's).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# reward and battery constants of EVChargingEnv (Yeh et al. 2023)
STEPS = 288
ACTION_SCALE = 32.0
VOLTAGE = 208.0
A_PERS_TO_KWH = (1 / 60) * (VOLTAGE / 1000) * 5
PROFIT_FACTOR = A_PERS_TO_KWH * 0.15 * 0.20
VIOLATION_FACTOR = A_PERS_TO_KWH * 0.001
CARBON_COST_FACTOR = A_PERS_TO_KWH * (30.85 / 1000)
BATTERY_CAPACITY = 100.0
BATTERY_MAX_POWER = 100.0
TRANSITION_SOC = 0.8
PHASES = (30.0, -90.0, 150.0)      # AB, BC, CA line assignments


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` rounded to ``prec`` and back to float32: "bf16", "fp8"
    (e4m3), "tf32" (10 mantissa bits, to nearest even) or "f32" (as is)."""
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    if prec == "tf32":
        bits = x.float().view(torch.int32)
        lsb = (bits >> 13) & 1
        return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x


def _mm(a, b, prec):
    return round_to(a, prec) @ round_to(b, prec)


# ---- the site -----------------------------------------------------------

def caltech_site():
    """(constraint matrix, phase angles, magnitudes, min pilots) of the
    Caltech ACN's 54 stations as the port reconstructs the site: two pods
    (8 ClipperCreek at 80 A, 8 AeroVironment at 160 A) and the 150 kVA
    transformer's secondary and primary line limits. These feeder and pod
    limits are the port's reconstruction, not acnportal's published
    ``caltech_acn`` network."""
    ids = [148, 149, 212, 213, *range(303, 328), *range(489, 514)]
    n = len(ids)
    cc = [ids.index(i) for i in range(489, 497)]
    av = [ids.index(i) for i in range(497, 505)]
    rest = [i for i in range(n) if i not in cc + av]
    phases = np.empty(n)
    phases[cc], phases[av] = PHASES[0], PHASES[1]
    for k, i in enumerate(rest):
        phases[i] = PHASES[k % 3]
    min_pilots = np.full(n, 8.0)
    min_pilots[cc] = 6.0
    rows, mags = [], []
    for pod, limit in ((cc, 80.0), (av, 160.0)):
        row = np.zeros(n)
        row[pod] = 1.0
        rows.append(row)
        mags.append(limit)
    kva = 150.0
    for coef, limit in ((1.0, kva * 1000 / 3 / 120),
                        (120.0 / 277.0, kva * 1000 / 3 / 277)):
        for plus, minus in ((0, 2), (1, 0), (2, 1)):
            row = np.zeros(n)
            row[phases == PHASES[plus]] = coef
            row[phases == PHASES[minus]] = -coef
            rows.append(row)
            mags.append(limit)
    return np.asarray(rows), phases, np.asarray(mags), min_pilots


class Reference:
    """The EV configuration's data, network and projection on
    ``device``."""

    def __init__(self, config: dict, device):
        make = config["make"]
        if make.get("site") != "caltech" or make.get("proj_method") != "dual":
            raise ValueError("the EV reference covers the Caltech site with "
                             "the dual-FISTA projection")
        dev = self.device = torch.device(device)
        packed = os.path.join(ROOT, *config["packs"]["dir"].split("/"))
        trace = np.load(os.path.join(packed, config["packs"]["trace"]))
        moer = np.load(os.path.join(packed, config["packs"]["moer"]))["moer"]
        cap = np.float32(make.get("requested_energy_cap", 100.0))
        ev = trace["ev_data"].copy()
        ev[..., 3] = np.minimum(ev[..., 3], cap)
        st, msk = trace["ev_station"], trace["ev_mask"]
        A, phases, mags, minp = caltech_site()
        n = self.n = A.shape[1]
        self.k = int(make.get("moer_forecast_steps", 36))
        self.n_days = moer.shape[0]
        # (day, t) rows of arrivals: departure, estimated departure, energy
        grid = np.zeros((3, ev.shape[0], STEPS + 1, n), np.float32)
        d_idx, s_idx = np.nonzero(msk)
        t0 = ev[d_idx, s_idx, 0].astype(int)
        stations = st[d_idx, s_idx]
        for c in range(3):
            grid[c, d_idx, t0, stations] = ev[d_idx, s_idx, c + 1]
        f32 = dict(dtype=torch.float32, device=dev)
        self.arrivals = torch.as_tensor(grid, **f32)      # (3, days, 289, n)
        self.moer = torch.as_tensor(moer, **f32)          # (days, 289, 37)
        self.moer_next = torch.cat([self.moer[:, 1:, 0],
                                    self.moer[:, -1:, 0]], 1)
        phase = np.exp(1j * np.deg2rad(phases))
        at = A * phase[None, :]
        C = np.empty((2 * A.shape[0], n))
        C[0::2], C[1::2] = at.real, at.imag
        m = A.shape[0]
        self.m = m
        G = np.abs(C @ C.T)
        step = 1.0 / np.maximum(G.reshape(m, 2, 2 * m).sum(-1).max(-1), 1e-12)
        step = step * 2.0     # the validated 2x step with gradient restart
        self.C = torch.as_tensor(C, **f32)
        self.radii = torch.as_tensor(mags / ACTION_SCALE, **f32)
        self.dual_step = torch.as_tensor(step, **f32)
        self.mags = torch.as_tensor(mags, **f32)
        self.min_pilots = torch.as_tensor(minp, **f32)
        self.iters = int(make.get("proj_iters") or 15)
        self.project = bool(make.get("project_action", True))
        self.obs_dim = 2 + 2 * n + self.k

    # ---- draws ----------------------------------------------------------
    def episode_draws(self, gen_state: torch.Tensor, batch: int):
        """(days (B,), kernel seed) of one episode, replayed from the
        benchmark generator's state before the program's call."""
        g = torch.Generator(device=self.device)
        g.set_state(gen_state)
        days = torch.randint(self.n_days, (1, batch), generator=g,
                             device=self.device)[0]
        seed = int(torch.randint(2 ** 62, (1,), generator=g,
                                 device=self.device))
        return days, seed, g

    def uniforms(self, seed: int, t: int, batch: int) -> torch.Tensor:
        """(B, n) U[0, 1) actions of step ``t`` (the simulation tier's
        kernel; the CPU's plain version draws in :meth:`sim_episode`)."""
        r = _philox_block(seed, t, batch, stream=0, device=self.device)
        return _by_station(_uniform01(r[0]), _uniform01(r[1]), self.n)

    def normals(self, seed: int, t: int, batch: int) -> torch.Tensor:
        """(B, n) N(0, 1) draws of step ``t`` (the PPO rollout)."""
        if self.device.type == "cpu":
            g = torch.Generator(device="cpu")
            g.manual_seed((seed + t * 0x9E3779B97F4A7C15) % 2 ** 64)
            u = torch.rand((batch, self.n, 2), generator=g)
            return torch.sqrt(-2.0 * torch.log1p(-u[..., 0])) * torch.cos(
                2.0 * math.pi * u[..., 1])
        r = _philox_block(seed, t, batch, stream=1, device=self.device)
        tau = float(np.float32(2.0 * math.pi))
        z0 = torch.sqrt(-2.0 * torch.log1p(-_uniform01(r[0]))) * torch.cos(
            tau * _uniform01(r[1]))
        z1 = torch.sqrt(-2.0 * torch.log1p(-_uniform01(r[2]))) * torch.cos(
            tau * _uniform01(r[3]))
        return _by_station(z0, z1, self.n)

    # ---- the env --------------------------------------------------------
    def reset(self, days: torch.Tensor) -> dict:
        B, n, dev = days.shape[0], self.n, self.device
        return {"day": days,
                "plugged": torch.zeros((B, n), dtype=torch.bool, device=dev),
                "dep": torch.zeros((B, n), dtype=torch.long, device=dev),
                "est": torch.zeros((B, n), dtype=torch.long, device=dev),
                "demand": torch.zeros((B, n), device=dev)}

    def obs(self, s: dict, t: int) -> torch.Tensor:
        """(B, obs_dim) flat obs before step ``t``: timestep, estimated
        departures, demands, the MOER now and its forecast."""
        B = s["day"].shape[0]
        est = torch.where(s["plugged"], (s["est"] - t).float(), 0.0)
        dem = torch.where(s["plugged"], s["demand"], 0.0)
        row = self.moer[s["day"], t]
        ts = torch.full((B, 1), float(t), device=self.device) / float(STEPS)
        return torch.cat([ts, est, dem, row[:, :1 + self.k]], -1)

    def step(self, s: dict, t: int, action: torch.Tensor, prec: str = "f32",
             count: torch.Tensor | None = None):
        """Advances every env one step under ``action`` (B, n) in [0, 1];
        returns (state, (B, 4) reward | profit | carbon | excess). Adds to
        ``count`` the mat-vecs with C the step needs (see
        :meth:`project_dual`)."""
        a = torch.clamp(action, 0.0, 1.0)
        if self.project:
            dem = torch.where(s["plugged"], s["demand"], 0.0)
            ub = torch.clamp(dem / A_PERS_TO_KWH / ACTION_SCALE, max=1.0)
            a = self.project_dual(a, ub, prec, count)
        amps = a * ACTION_SCALE
        cc = torch.where(amps >= 6.0, torch.round(amps), 0.0)
        av = torch.round(amps / 8.0) * 8.0
        pilots = torch.where(self.min_pilots == 6.0, cc, av)
        day = s["day"]
        dep_row, est_row, req_row = (self.arrivals[c, day, t]
                                     for c in range(3))
        plugged = s["plugged"] & (s["dep"] != t)
        arrive = dep_row > 0
        plugged = plugged | arrive
        dep = torch.where(arrive, dep_row.long(), s["dep"])
        est = torch.where(arrive, est_row.long(), s["est"])
        demand = torch.where(arrive, req_row, s["demand"])
        # two-stage battery: full power below 80% state of charge, then a
        # linear taper, never past the remaining demand in one period
        pilot_kw = pilots * VOLTAGE / 1000.0
        soc = 1.0 - demand / BATTERY_CAPACITY
        taper = BATTERY_MAX_POWER * (1.0 - soc) / (1.0 - TRANSITION_SOC)
        cap = torch.where(soc < TRANSITION_SOC, BATTERY_MAX_POWER, taper)
        power = torch.minimum(torch.minimum(pilot_kw, cap),
                              demand * (60.0 / 5))
        power = torch.where(plugged, torch.clamp(power, min=0.0), 0.0)
        energy = power * (5 / 60.0)
        rates = power * 1000.0 / VOLTAGE
        demand = demand - energy
        total = torch.sum(rates, -1)
        profit = PROFIT_FACTOR * total
        agg = _mm(pilots, self.C.T, prec).reshape(pilots.shape[0], -1, 2)
        if count is not None:
            count += pilots.shape[0]
        mag = torch.sqrt(torch.sum(agg * agg, -1))
        excess = torch.sum(torch.where(
            self.mags > 0.0, torch.clamp(mag - self.mags, min=0.0), 0.0), -1)
        excess = excess * VIOLATION_FACTOR
        carbon = CARBON_COST_FACTOR * total * self.moer_next[day, t]
        out = torch.stack([profit - carbon - excess, profit, carbon, excess],
                          -1)
        return {"day": day, "plugged": plugged, "dep": dep, "est": est,
                "demand": demand}, out

    def project_dual(self, a, ub, prec="f32", count=None):
        """Projects ``a`` onto {0 <= x <= ub, ||C_k x|| <= r_k} by
        ``iters`` iterations of dual FISTA with gradient restart.

        ``count`` gets the mat-vecs with C the projection needs: an
        iteration's C x, its C' y where y is not 0, until the first
        iteration that leaves (lam, lam_prev) as they were (every later one
        repeats it), then the final C' lam where lam is not 0."""
        B, m = a.shape[0], self.m
        C = self.C
        lam = torch.zeros((B, 2 * m), device=a.device)
        lam_prev = lam
        tk = torch.ones(B, device=a.device)
        t2 = torch.repeat_interleave(self.dual_step, 2)
        tr = self.dual_step * self.radii
        live = torch.ones(B, dtype=torch.bool, device=a.device)
        for _ in range(self.iters):
            tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
            beta = (tk - 1.0) / tk1
            y = lam + beta[:, None] * (lam - lam_prev)
            xbar = torch.minimum(torch.clamp(a - _mm(y, C, prec), min=0.0),
                                 ub)
            w = y + t2 * _mm(xbar, C.T, prec)
            pairs = w.reshape(B, m, 2)
            nr = torch.sqrt(torch.sum(pairs * pairs, -1) + 1e-12)
            lam_new = (pairs * torch.clamp(1.0 - tr / nr, min=0.0)[..., None]
                       ).reshape(B, 2 * m)
            prog = torch.sum((lam_new - lam) * (lam - lam_prev), -1)
            tk1 = torch.where(prog < 0.0, torch.ones_like(tk1), tk1)
            if count is not None:
                count += (live & (y != 0).any(-1)).sum() + live.sum()
                live = live & ~((lam_new == lam).all(-1)
                                & (lam == lam_prev).all(-1))
            lam_prev, lam, tk = lam, lam_new, tk1
        if count is not None:
            count += (lam != 0).any(-1).sum()
        return torch.minimum(torch.clamp(a - _mm(lam, C, prec), min=0.0), ub)

    # ---- episodes -------------------------------------------------------
    def sim_episode(self, days, seed: int, prec: str = "f32", count=None,
                    fault: str | None = None):
        """(T, B, 4) outputs of one episode of uniform random actions
        (the simulation tier's ``fused_rollout``). ``fault`` plants one of
        the faults the check must catch: "frozen_state" (each step returns
        the state it was given), "half_batch" (the second half of the envs
        left out, their outputs 0) or "altered_output" (one reward
        changed)."""
        B = days.shape[0]
        s = self.reset(days)
        gen = None
        if self.device.type == "cpu":
            gen = torch.Generator(device="cpu")
            gen.manual_seed(seed)
        outs = []
        for t in range(STEPS):
            a = (torch.rand((B, self.n), generator=gen) if gen is not None
                 else self.uniforms(seed, t, B))
            s_next, out = self.step(s, t, a, prec, count)
            s = s if fault == "frozen_state" else s_next
            outs.append(out)
        out = torch.stack(outs)
        if fault == "half_batch":
            out[:, B // 2:] = 0.0
        elif fault == "altered_output":
            out[100, 0, 0] += 1.0
        return out

    def policy_episode(self, actor, days, seed: int, prec: str = "f32",
                       count=None):
        """One episode with the actor ``actor(obs) -> (mu, sigma)`` at
        every step: returns (obs (T, B, D) as the actor saw them, u (T, B,
        n) f32 pre-squash draws, out (T, B, 4))."""
        B = days.shape[0]
        s = self.reset(days)
        obs_t, u_t, outs = [], [], []
        for t in range(STEPS):
            obs, mu, sigma = actor(self.obs(s, t))
            u = mu + sigma * self.normals(seed, t, B)
            s, out = self.step(s, t, torch.tanh(u) * 0.5 + 0.5, prec, count)
            obs_t.append(obs)
            u_t.append(u)
            outs.append(out)
        return torch.stack(obs_t), torch.stack(u_t), torch.stack(outs)


# ---- Philox4x32-10 in int64 arithmetic -----------------------------------

_MASK = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, b: int):
    """(hi, lo) 32-bit words of the 64-bit product of 32-bit ``a`` and
    ``b``, in int64 without overflow."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & _MASK


def philox4x32_10(c, key: int):
    """Philox4x32-10 of counters ``c`` (four int64 tensors of 32-bit
    words) under the 64-bit ``key``."""
    c0, c1, c2, c3 = c
    k0, k1 = key & _MASK, (key >> 32) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK
        k1 = (k1 + 0xBB67AE85) & _MASK
    return c0, c1, c2, c3


def _philox_block(seed: int, t: int, batch: int, stream: int, device):
    """The four words of counter (lane, t, env, stream) for every env and
    lane: (B, 32) each."""
    lane = torch.arange(32, device=device, dtype=torch.long)[None, :]
    env = torch.arange(batch, device=device, dtype=torch.long)[:, None]
    shape = (batch, 32)
    c = (lane.expand(shape), torch.full(shape, t, dtype=torch.long,
                                        device=device),
         env.expand(shape), torch.full(shape, stream, dtype=torch.long,
                                       device=device))
    return philox4x32_10(c, seed % 2 ** 64)


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """U[0, 1) from the top 23 bits of a 32-bit word."""
    return (bits >> 9).float() * (2.0 ** -23)


def _by_station(first: torch.Tensor, second: torch.Tensor, n: int):
    """(B, n): station s < 32 takes lane s's first value, station s >= 32
    lane s - 32's second."""
    return torch.cat([first, second], -1)[:, :n]
