"""Plain reference of the electricity-market configuration: SustainGym's
ElectricityMarketEnv (one 80 MWh / 20 MW battery bidding into a 5-minute
SCED market on the IEEE RTS-24 network), in plain PyTorch.

It imports nothing of the program. From its own copy of the published
tables (Grigg et al., "The IEEE Reliability Test System-1996", IEEE Trans.
Power Systems 14(3), 1999: bus loads, branch reactances and ratings, the
generator fleet) it builds the network's PTDF and the SCED LP of each
step, and clears it with the fixed-iteration preconditioned PDHG
(Chambolle-Pock) whose equations head ``lp_solve.cu``:

    grad = c + A' r(y) + S' r(zp - zm)
    x+   = clip(x - tau grad, 0, ub);  xb = 2 x+ - x
    y+   = y + sigma_a (A r(xb) - b)
    s    = S r(xb)
    zp+  = max(0, zp + sigma_s (s - hp));  zm+ = max(0, zm + sigma_s (-s - hm))

where r rounds a product's operand to ``prec`` ("bf16", the
configuration's; "fp8", the control's e4m3, saturating at 448; "f32" or
"f64" none) and every sum is kept in float32 (float64 for "f64"). The
matrices are rounded the same way. An episode's first solve runs the cold
budget from zeros; every later one runs the warm budget from the previous
solution with its per-interval blocks shifted one interval (the last
repeated). The price is minus the dual of the first interval's power
balance, the battery's dispatch its first-interval charge and discharge.

Its inputs are the reset days and the bids, replayed from the benchmark
generator's saved state in the order the program draws them: one randint
of the days over the batch, then one U[0, 1) draw of (B, 2k) bids a step,
scaled to [0, 1000] $/MWh.

Departures from the spec (``docs/electricitymarketenv.md``), each as the
configuration states it (its ``assumed``):

- the published fleet has 32 units; a 60 MW gas peaker at bus 10 makes
  the spec's 33;
- marginal costs are per-fuel approximations, not the RTS heat-rate
  curves; no unit has a minimum output, ramp limit or commitment;
- branch ratings are by voltage level (175 / 400 MW at 138 kV, 500 MW at
  230 kV), not the published per-branch ratings;
- the load is a deterministic CAISO-like synthesis scaled to the 2850 MW
  RTS peak and split over the buses by their RTS shares (the RTS-GMLC
  series are not in the repository); the horizon's last intervals read
  the next day's head;
- the SCED solve is the fixed-iteration PDHG above, not an exact LP
  solve: its price is the iterate's dual after the budget, as the
  program's is;
- horizon 4, a warm budget of 40 and a preconditioner exponent of 0.35,
  where the spec's text gives 60 and 0.5.
"""
from __future__ import annotations

import datetime as dt
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STEPS = 288
TAU_H = 1.0 / 12.0                 # a 5-minute interval in hours
P_CO2 = 30.85 / 1000.0             # $/kg CO2
MAX_BID = 1000.0                   # $/MWh
CAPACITY = 80.0                    # MWh
POWER = 20.0                       # MW
EFFICIENCY = 0.95
BATTERY_BUS = 15
SLACK_BUS = 13
PEAK_LOAD = 2850.0                 # MW

# bus: share of the system load (RTS Table 5)
LOAD_SHARE = {1: 0.038, 2: 0.034, 3: 0.063, 4: 0.026, 5: 0.025,
              6: 0.048, 7: 0.044, 8: 0.060, 9: 0.061, 10: 0.068,
              13: 0.093, 14: 0.068, 15: 0.111, 16: 0.035, 18: 0.117,
              19: 0.064, 20: 0.045}

# marginal cost $/MWh by fuel, and the units of each (bus, MW, fuel)
COST = {"oil-ct": 130.0, "coal-76": 13.3, "oil-100": 43.7, "oil-197": 48.6,
        "oil-12": 56.0, "coal-155": 10.5, "nuclear": 4.4, "hydro": 0.5,
        "coal-350": 11.2, "gas-peaker": 150.0}
UNITS = ([(1, 20, "oil-ct")] * 2 + [(1, 76, "coal-76")] * 2
         + [(2, 20, "oil-ct")] * 2 + [(2, 76, "coal-76")] * 2
         + [(7, 100, "oil-100")] * 3 + [(13, 197, "oil-197")] * 3
         + [(15, 12, "oil-12")] * 5 + [(15, 155, "coal-155")]
         + [(16, 155, "coal-155")] + [(18, 400, "nuclear")]
         + [(21, 400, "nuclear")] + [(22, 50, "hydro")] * 6
         + [(23, 155, "coal-155")] * 2 + [(23, 350, "coal-350")]
         + [(10, 60, "gas-peaker")])

# (from bus, to bus, reactance p.u., rating MW)
BRANCHES = [
    (1, 2, 0.0139, 175), (1, 3, 0.2112, 175), (1, 5, 0.0845, 175),
    (2, 4, 0.1267, 175), (2, 6, 0.1920, 175), (3, 9, 0.1190, 175),
    (3, 24, 0.0839, 400), (4, 9, 0.1037, 175), (5, 10, 0.0883, 175),
    (6, 10, 0.0605, 175), (7, 8, 0.0614, 175), (8, 9, 0.1651, 175),
    (8, 10, 0.1651, 175), (9, 11, 0.0839, 400), (9, 12, 0.0839, 400),
    (10, 11, 0.0839, 400), (10, 12, 0.0839, 400), (11, 13, 0.0476, 500),
    (11, 14, 0.0418, 500), (12, 13, 0.0476, 500), (12, 23, 0.0966, 500),
    (13, 23, 0.0865, 500), (14, 16, 0.0389, 500), (15, 16, 0.0173, 500),
    (15, 21, 0.0490, 500), (15, 21, 0.0490, 500), (15, 24, 0.0519, 500),
    (16, 17, 0.0259, 500), (16, 19, 0.0231, 500), (17, 18, 0.0144, 500),
    (17, 22, 0.1053, 500), (18, 21, 0.0259, 500), (18, 21, 0.0259, 500),
    (19, 20, 0.0396, 500), (19, 20, 0.0396, 500), (20, 23, 0.0216, 500),
    (20, 23, 0.0216, 500), (21, 22, 0.0678, 500)]
N_BUS = 24

# the change of the one altered reward of the "altered_output" fault, $
ALTERED = 100.0


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` rounded to ``prec`` and back to its dtype: "bf16", "fp8"
    (e4m3, saturating at its largest finite value, 448), "f32" or "f64"
    (as is)."""
    if prec == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if prec == "fp8":
        return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)
    return x


def ptdf() -> np.ndarray:
    """(branches, buses) DC power-transfer distribution factors, float64:
    each branch's flow per MW injected at a bus and taken out at the slack
    bus (whose column is 0)."""
    nl = len(BRANCHES)
    incidence = np.zeros((nl, N_BUS))
    for i, (f, t, _, _) in enumerate(BRANCHES):
        incidence[i, f - 1], incidence[i, t - 1] = 1.0, -1.0
    b = np.diag([1.0 / x for _, _, x, _ in BRANCHES])
    bf = b @ incidence
    bbus = incidence.T @ bf
    keep = [i for i in range(N_BUS) if i != SLACK_BUS - 1]
    out = np.zeros((nl, N_BUS))
    out[:, keep] = np.linalg.solve(bbus[np.ix_(keep, keep)],
                                   bf[:, keep].T).T
    # a bus that sends no flow over a branch (one behind a radial branch)
    # reads as rounding noise of ~1e-16: its exact 0
    out[np.abs(out) < 1e-12] = 0.0
    return out


def sced_lp(k: int) -> dict:
    """The SCED LP's fixed parts over ``k`` intervals, float64. Variables
    x = [generation of each unit, interval by interval | charge (k) |
    discharge (k)], MW. Rows: ``A`` (k) the power balance, sum g + d - c =
    load; ``S`` the paired rows, +S x <= hp and -S x <= hm: each
    interval's branch flows (the PTDF of the injections; the load's part
    goes into hp and hm), then each interval's cumulative battery energy
    (charge in at the efficiency, discharge out over it). ``load_sf``: the
    branch flows of 1 MW of system load spread by the bus shares."""
    H = ptdf()
    ng, nl = len(UNITS), len(BRANCHES)
    n = ng * k + 2 * k
    ic, idd = ng * k, ng * k + k
    gen_sf = H[:, [bus - 1 for bus, _, _ in UNITS]]
    bat_sf = H[:, BATTERY_BUS - 1]
    share = np.zeros(N_BUS)
    for bus, s in LOAD_SHARE.items():
        share[bus - 1] = s
    A = np.zeros((k, n))
    S = np.zeros((k * nl + k, n))
    for tau in range(k):
        A[tau, tau * ng:(tau + 1) * ng] = 1.0
        A[tau, ic + tau], A[tau, idd + tau] = -1.0, 1.0
        rows = slice(tau * nl, (tau + 1) * nl)
        S[rows, tau * ng:(tau + 1) * ng] = gen_sf
        S[rows, ic + tau], S[rows, idd + tau] = -bat_sf, bat_sf
        S[k * nl + tau, ic:ic + tau + 1] = EFFICIENCY * TAU_H
        S[k * nl + tau, idd:idd + tau + 1] = -TAU_H / EFFICIENCY
    ub = np.concatenate([np.tile([float(p) for _, p, _ in UNITS], k),
                         np.full(2 * k, POWER)])
    return {"A": A, "S": S, "ub": ub, "ic": ic, "id": idd,
            "gen_cost": np.array([COST[f] for _, _, f in UNITS]),
            "rating": np.array([float(r) for *_, r in BRANCHES]),
            "load_sf": H @ (share / share.sum())}


def synthetic_load(n_days: int, month: int, seed: int = 7) -> np.ndarray:
    """(n_days, 289) MW: the configuration's deterministic CAISO-like day
    (a diurnal cosine, an evening and a midday bump, a day offset and a
    random walk from ``default_rng(seed + month)``), scaled by season to
    the RTS peak and clipped to 35-95% of it."""
    rng = np.random.default_rng(seed + month)
    t = np.arange(STEPS + 1) / STEPS
    season = 1.0 + 0.12 * np.cos(2 * np.pi * (month - 7.5) / 12.0)
    shape = (0.62 - 0.10 * np.cos(2 * np.pi * (t - 0.08))
             + 0.16 * np.exp(-0.5 * ((t - 0.79) / 0.09) ** 2)
             + 0.05 * np.exp(-0.5 * ((t - 0.5) / 0.2) ** 2))
    out = np.empty((n_days, STEPS + 1))
    for d in range(n_days):
        walk = rng.normal(scale=0.004, size=STEPS + 1).cumsum()
        out[d] = PEAK_LOAD * np.clip(
            season * (shape + 0.03 * rng.normal() + walk), 0.35, 0.95)
    return out


class Reference:
    """The market configuration's data and SCED on ``device``, in
    ``dtype`` (float32; float64 for the solver's own tests)."""

    capacity, max_bid = CAPACITY, MAX_BID

    def __init__(self, config: dict, device, dtype=torch.float32):
        make = config["make"]
        if make.get("discrete") or not make.get("intermediate_rewards",
                                                True):
            raise ValueError("the market reference covers Box bids with "
                             "intermediate rewards")
        dev = self.device = torch.device(device)
        self.dtype = dtype
        k = self.k = int(make["horizon"])
        self.cold = int(make["lp_iters"])
        self.warm = int(make["lp_warm_iters"])
        alpha = float(make["lp_precond_alpha"])
        year, month = (int(s) for s in make["month"].split("-"))
        first = dt.date(year, month, 1)
        nxt = dt.date(year + month // 12, month % 12 + 1, 1)
        packed = os.path.join(ROOT, *config["packs"]["dir"].split("/"))
        moer = np.load(os.path.join(packed, config["packs"]["moer"]))["moer"]
        self.n_days = (nxt - first).days
        if moer.shape[0] != self.n_days:
            raise ValueError(f"the MOER pack holds {moer.shape[0]} days, "
                             f"the month {self.n_days}")
        load = synthetic_load(self.n_days, month)
        # the horizon past the day's end reads the next day's head
        load = np.concatenate([load, np.roll(load, -1, 0)[:, :k]], 1)
        lp = sced_lp(k)
        K = np.vstack([lp["A"], lp["S"], -lp["S"]])
        tau = 1.0 / np.maximum((np.abs(K) ** (2.0 - alpha)).sum(0), 1e-6)

        def sigma(m):
            return 1.0 / np.maximum((np.abs(m) ** alpha).sum(1), 1e-6)

        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        self.lp = lp
        self.A, self.S, self.ub = put(lp["A"]), put(lp["S"]), put(lp["ub"])
        self.tau, self.sig_a, self.sig_s = (put(tau), put(sigma(lp["A"])),
                                            put(sigma(lp["S"])))
        self.gen_cost = put(np.tile(lp["gen_cost"], k))
        self.rating, self.load_sf = put(lp["rating"]), put(lp["load_sf"])
        self.load, self.moer = put(load), put(moer[:, :, 0])
        self.ic, self.id = lp["ic"], lp["id"]
        self.n, self.me, self.ms = (lp["A"].shape[1], lp["A"].shape[0],
                                    lp["S"].shape[0])
        self.shift = self._shifts(len(UNITS), len(BRANCHES))

    def _shifts(self, ng: int, nl: int) -> dict:
        """Index maps that move each per-interval block of x, y and z one
        interval earlier, the last interval's block repeated."""
        k, dev = self.k, self.device
        nxt = np.minimum(np.arange(k) + 1, k - 1)
        x = np.concatenate([(nxt[:, None] * ng + np.arange(ng)).ravel(),
                            self.ic + nxt, self.id + nxt])
        z = np.concatenate([(nxt[:, None] * nl + np.arange(nl)).ravel(),
                            k * nl + nxt])
        return {key: torch.as_tensor(v, device=dev)
                for key, v in (("x", x), ("y", nxt), ("z", z))}

    def solve_iters(self, steps: int = STEPS) -> list[int]:
        """The PDHG iterations of each solve of an episode of ``steps``."""
        return [self.cold] + [self.warm] * (steps - 1)

    # ---- draws ----------------------------------------------------------
    def episode_draws(self, gen_state: torch.Tensor, batch: int,
                      steps: int = STEPS):
        """(days (B,), bids (steps, B, 2k)) of one episode, replayed from
        the benchmark generator's state before the program's call."""
        g = torch.Generator(device=self.device)
        g.set_state(gen_state)
        days = torch.randint(self.n_days, (batch,), generator=g,
                             device=self.device)
        bids = torch.stack([
            torch.rand((batch, 2 * self.k), generator=g, device=self.device)
            * MAX_BID for _ in range(steps)])
        return days, bids

    # ---- the SCED -------------------------------------------------------
    def problem(self, day, t: int, energy):
        """(b (B, k) loads, hp, hm (B, ms)) of step ``t``."""
        k = self.k
        b = self.load[day[:, None], t + torch.arange(k, device=self.device)]
        flow = self.load_sf * b[:, :, None]                   # (B, k, nl)
        B = b.shape[0]
        room = (CAPACITY - energy)[:, None].expand(B, k)
        hp = torch.cat([(self.rating + flow).reshape(B, -1), room], 1)
        hm = torch.cat([(self.rating - flow).reshape(B, -1),
                        energy[:, None].expand(B, k)], 1)
        return b, hp, hm

    def solve(self, c, b, hp, hm, start, iters: int, prec: str):
        """``iters`` PDHG iterations from ``start`` (x, y, zp, zm); returns
        the last iterate."""
        x, y, zp, zm = start
        A, S = round_to(self.A, prec), round_to(self.S, prec)
        x = torch.minimum(x.clamp_min(0.0), self.ub)
        zp, zm = zp.clamp_min(0.0), zm.clamp_min(0.0)
        for _ in range(iters):
            grad = c + round_to(y, prec) @ A + round_to(zp - zm, prec) @ S
            x_new = torch.minimum((x - self.tau * grad).clamp_min(0.0),
                                  self.ub)
            xb = round_to(2.0 * x_new - x, prec)
            y = y + self.sig_a * (xb @ A.T - b)
            s = xb @ S.T
            zp = (zp + self.sig_s * (s - hp)).clamp_min(0.0)
            zm = (zm + self.sig_s * (-s - hm)).clamp_min(0.0)
            x = x_new
        return x, y, zp, zm

    def costs(self, bids) -> torch.Tensor:
        """(B, n) the LP's costs: the units' marginal costs, minus the
        charge bids, the discharge bids."""
        k = self.k
        return torch.cat([self.gen_cost.expand(bids.shape[0], -1),
                          -bids[:, :k], bids[:, k:]], 1)

    # ---- a step's own arithmetic ----------------------------------------
    def recompute(self, days, out: dict) -> dict:
        """What the env's rules make of an episode's recorded per-step
        ``price``, ``dispatch_mwh`` and ``energy_level`` ((T, B), from a
        reset on ``days``), in float64: each step's ``reward``,
        ``revenue``, ``carbon_value`` and ``terminal_cost``, and the range
        ``energy_lo`` .. ``energy_hi`` that its energy must lie in: the
        previous energy (the reset's half capacity at the first step)
        moved by each split of the step's net dispatch into a charge and a
        discharge within the battery's power (the outputs hold only their
        difference), clipped to the capacity."""
        f64, dev = torch.float64, self.device
        price = out["price"].to(dev, f64)
        dispatch = out["dispatch_mwh"].to(dev, f64)
        energy = out["energy_level"].to(dev, f64)
        T, B = price.shape
        moer = self.moer.to(f64)[days][:, :T].T * 1000.0       # kg/MWh
        revenue = price * dispatch
        carbon = P_CO2 * moer * dispatch
        terminal = torch.zeros_like(price)
        if T == STEPS:
            terminal[-1] = 2.0 * price.mean(0) * torch.clamp_min(
                CAPACITY / 2.0 - energy[-1], 0.0)
        prev = torch.cat([torch.full((1, B), CAPACITY / 2.0, dtype=f64,
                                     device=dev), energy[:-1]])
        net = dispatch / TAU_H                  # discharge - charge, MW

        def moved(charge):
            return torch.clamp(prev + (EFFICIENCY * charge - (charge + net)
                                       / EFFICIENCY) * TAU_H, 0.0, CAPACITY)
        a = moved((-net).clamp(0.0, POWER))
        b = moved((POWER - net).clamp(0.0, POWER))
        return {"reward": revenue + carbon - terminal, "revenue": revenue,
                "carbon_value": carbon, "terminal_cost": terminal,
                "energy_lo": torch.minimum(a, b),
                "energy_hi": torch.maximum(a, b)}

    # ---- episodes -------------------------------------------------------
    def episode(self, days, bids, prec: str = "bf16",
                fault: str | None = None) -> dict:
        """(T, B) outputs of one episode of the given bids from a reset on
        ``days``: ``reward``, ``revenue``, ``carbon_value``,
        ``terminal_cost``, ``price``, ``dispatch_mwh``, ``energy_level``.
        ``fault`` plants one of the faults the check must catch:
        "half_warm_budget" (20 warm iterations), "unshifted_warm_start"
        (the previous solution as it is), "frozen_energy" (the battery's
        energy kept at its reset value), "half_batch" (the second half of
        the envs left out, their outputs 0) or "altered_output" (one
        reward changed)."""
        T, B = bids.shape[0], days.shape[0]
        dev, dt_ = self.device, self.dtype
        energy = torch.full((B,), CAPACITY / 2.0, dtype=dt_, device=dev)
        energy0, price_sum = energy, torch.zeros_like(energy)
        sol = (torch.zeros((B, self.n), dtype=dt_, device=dev),
               torch.zeros((B, self.me), dtype=dt_, device=dev),
               torch.zeros((B, self.ms), dtype=dt_, device=dev),
               torch.zeros((B, self.ms), dtype=dt_, device=dev))
        warm = 20 if fault == "half_warm_budget" else self.warm
        out = {key: [] for key in ("reward", "revenue", "carbon_value",
                                   "terminal_cost", "price", "dispatch_mwh",
                                   "energy_level")}
        for t in range(T):
            a = bids[t].to(dt_).clamp(0.0, MAX_BID)
            b, hp, hm = self.problem(days, t, energy)
            if t > 0 and fault != "unshifted_warm_start":
                x, y, zp, zm = sol
                z = self.shift["z"]
                sol = (x[:, self.shift["x"]], y[:, self.shift["y"]],
                       zp[:, z], zm[:, z])
            sol = self.solve(self.costs(a), b, hp, hm, sol,
                             self.cold if t == 0 else warm, prec)
            x, y = sol[0], sol[1]
            price, charge, discharge = -y[:, 0], x[:, self.ic], x[:, self.id]
            dispatch = (discharge - charge) * TAU_H
            new_energy = torch.clamp(
                energy + (EFFICIENCY * charge - discharge / EFFICIENCY)
                * TAU_H, 0.0, CAPACITY)
            if fault != "frozen_energy":
                energy = new_energy
            revenue = price * dispatch
            carbon = P_CO2 * (self.moer[days, t] * 1000.0) * dispatch
            price_sum = price_sum + price
            terminal = torch.zeros_like(energy)
            if t + 1 == STEPS:
                terminal = 2.0 * (price_sum / (t + 1)) * torch.clamp_min(
                    energy0 - energy, 0.0)
            for key, v in (("reward", revenue + carbon - terminal),
                           ("revenue", revenue), ("carbon_value", carbon),
                           ("terminal_cost", terminal), ("price", price),
                           ("dispatch_mwh", dispatch),
                           ("energy_level", energy)):
                out[key].append(v)
        out = {key: torch.stack(v) for key, v in out.items()}
        if fault == "half_batch":
            for v in out.values():
                v[:, B // 2:] = 0.0
        elif fault == "altered_output":
            out["reward"][100 % T, 0] += ALTERED
        return out

