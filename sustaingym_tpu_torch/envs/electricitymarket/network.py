"""IEEE RTS-24 network + generator fleet for ElectricityMarketEnv: a NumPy
copy of ``sustaingym_tpu.envs.electricitymarket.network`` (the port imports
nothing of the JAX package).

The environment is a documentation spec without a reference
implementation. This module encodes the published IEEE RTS-79/RTS-24
system: bus load shares, the 32-unit generator fleet (plus one gas peaker
to reach the 33 dispatchable units of the spec), and the 38-branch
transmission network, from which a PTDF matrix is computed for DC
power-flow (SCED) constraints. Marginal costs are standard per-fuel
approximations (the spec's "fixed true cost of generation").
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

N_BUS = 24
PEAK_LOAD_MW = 2850.0

# bus -> share of system load (IEEE RTS-79 Table: bus load % of 2850 MW)
BUS_LOAD_SHARE = {
    1: 0.038, 2: 0.034, 3: 0.063, 4: 0.026, 5: 0.025, 6: 0.048,
    7: 0.044, 8: 0.060, 9: 0.061, 10: 0.068, 13: 0.093, 14: 0.068,
    15: 0.111, 16: 0.035, 18: 0.117, 19: 0.064, 20: 0.045,
}

# (bus, Pmax MW, marginal cost $/MWh, fuel) — RTS-79 fleet + 1 peaker
GENERATORS = [
    (1, 20, 130.0, "oil-ct"), (1, 20, 130.0, "oil-ct"),
    (1, 76, 13.3, "coal"), (1, 76, 13.3, "coal"),
    (2, 20, 130.0, "oil-ct"), (2, 20, 130.0, "oil-ct"),
    (2, 76, 13.3, "coal"), (2, 76, 13.3, "coal"),
    (7, 100, 43.7, "oil"), (7, 100, 43.7, "oil"), (7, 100, 43.7, "oil"),
    (13, 197, 48.6, "oil"), (13, 197, 48.6, "oil"), (13, 197, 48.6, "oil"),
    (15, 12, 56.0, "oil"), (15, 12, 56.0, "oil"), (15, 12, 56.0, "oil"),
    (15, 12, 56.0, "oil"), (15, 12, 56.0, "oil"),
    (15, 155, 10.5, "coal"),
    (16, 155, 10.5, "coal"),
    (18, 400, 4.4, "nuclear"),
    (21, 400, 4.4, "nuclear"),
    (22, 50, 0.5, "hydro"), (22, 50, 0.5, "hydro"), (22, 50, 0.5, "hydro"),
    (22, 50, 0.5, "hydro"), (22, 50, 0.5, "hydro"), (22, 50, 0.5, "hydro"),
    (23, 155, 10.5, "coal"), (23, 155, 10.5, "coal"),
    (23, 350, 11.2, "coal"),
    (10, 60, 150.0, "gas-peaker"),
]

# (from, to, reactance pu, rating MW) — RTS-79 branch data, ratings by
# voltage level (138 kV: 175/400 MW cables, 230 kV: 500 MW)
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
    (20, 23, 0.0216, 500), (21, 22, 0.0678, 500),
]

BATTERY_BUS = 15
BATTERY_CAPACITY_MWH = 80.0     # doc spec
BATTERY_POWER_MW = 20.0         # 4-hour duration
BATTERY_EFFICIENCY = 0.95


class MarketNetwork(NamedTuple):
    gen_bus: np.ndarray        # (n_gen,)
    gen_pmax: np.ndarray       # (n_gen,) MW
    gen_cost: np.ndarray       # (n_gen,) $/MWh
    load_dist: np.ndarray      # (N_BUS,) shares summing to 1
    ptdf: np.ndarray           # (n_lines, N_BUS)
    line_rating: np.ndarray    # (n_lines,) MW
    n_gen: int
    n_lines: int


def build_network(slack_bus: int = 13) -> MarketNetwork:
    """Builds the PTDF (injection-shift-factor) matrix via
    H = Bf @ pinv(Bbus) with the slack column zeroed."""
    n_l = len(BRANCHES)
    Bf = np.zeros((n_l, N_BUS))
    Bbus = np.zeros((N_BUS, N_BUS))
    for li, (f, t, x, _) in enumerate(BRANCHES):
        f -= 1
        t -= 1
        b = 1.0 / x
        Bf[li, f] = b
        Bf[li, t] = -b
        Bbus[f, f] += b
        Bbus[t, t] += b
        Bbus[f, t] -= b
        Bbus[t, f] -= b
    s = slack_bus - 1
    keep = [i for i in range(N_BUS) if i != s]
    ptdf = np.zeros((n_l, N_BUS))
    ptdf[:, keep] = Bf[:, keep] @ np.linalg.inv(Bbus[np.ix_(keep, keep)])

    load_dist = np.zeros(N_BUS)
    for bus, share in BUS_LOAD_SHARE.items():
        load_dist[bus - 1] = share
    load_dist = load_dist / load_dist.sum()

    return MarketNetwork(
        gen_bus=np.array([g[0] - 1 for g in GENERATORS]),
        gen_pmax=np.array([float(g[1]) for g in GENERATORS]),
        gen_cost=np.array([float(g[2]) for g in GENERATORS]),
        load_dist=load_dist,
        ptdf=ptdf,
        line_rating=np.array([float(b[3]) for b in BRANCHES]),
        n_gen=len(GENERATORS),
        n_lines=n_l,
    )


def build_sced_matrices(net: MarketNetwork, horizon: int
                        ) -> dict[str, np.ndarray]:
    """Assembles the static SCED LP structure over ``horizon`` settlement
    intervals. Variable layout: x = [g(n_gen) per tau..., c(horizon),
    d(horizon)].

    Equalities (duals -> prices): per-tau system balance
        sum_i g_{i,tau} + d_tau - c_tau = L_tau
    Inequalities: +/- line flows via PTDF, battery energy envelope.
    """
    ng, nl, k = net.n_gen, net.n_lines, horizon
    n = ng * k + 2 * k
    ic = ng * k          # offset of c block
    idd = ng * k + k     # offset of d block

    A = np.zeros((k, n))
    for tau in range(k):
        A[tau, tau * ng:(tau + 1) * ng] = 1.0
        A[tau, idd + tau] = 1.0
        A[tau, ic + tau] = -1.0

    gen_sf = net.ptdf[:, net.gen_bus]              # (nl, ng)
    bat_sf = net.ptdf[:, BATTERY_BUS - 1]          # (nl,)
    load_sf = net.ptdf @ net.load_dist             # (nl,)

    # line-flow limits are TWO-SIDED (|flow| <= rating): emit the flow rows
    # once as the paired block S (ops/lp.py `sym`) so the PDHG matvec is
    # shared between the +/- sides. Energy-envelope rows are also +/- pairs
    # of the same cumulative-energy row, so they join S too; G_rest is empty.
    sym_rows = []
    for tau in range(k):
        blk = np.zeros((nl, n))
        blk[:, tau * ng:(tau + 1) * ng] = gen_sf
        blk[:, idd + tau] = bat_sf
        blk[:, ic + tau] = -bat_sf
        sym_rows.append(blk)
    # battery energy: for each tau, the cumulative-energy row e_tau with
    #   +e_tau <= E - e0   and   -e_tau <= e0
    tau_h = 1.0 / 12.0  # 5 minutes in hours
    eta = BATTERY_EFFICIENCY
    for tau in range(k):
        row = np.zeros((1, n))
        row[0, ic:ic + tau + 1] = eta * tau_h          # charging adds
        row[0, idd:idd + tau + 1] = -tau_h / eta       # discharging drains
        sym_rows.append(row)
    S = np.vstack(sym_rows)

    # fully stacked one-sided form [S; -S] kept for oracle solvers
    # (tests vs scipy HiGHS) and any consumer of the plain LP structure
    G = np.vstack([S, -S])

    ub = np.concatenate([
        np.tile(net.gen_pmax, k),
        np.full(2 * k, BATTERY_POWER_MW)])

    return {
        "A": A, "S": S, "G": G, "ub": ub,
        "gen_sf": gen_sf, "bat_sf": bat_sf, "load_sf": load_sf,
        "n": n, "ic": ic, "id": idd,
    }
