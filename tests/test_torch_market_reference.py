"""The benchmark's plain reference of the electricity market
(``h100_bench/reference/market.py``) against the port on the CPU: its LP
against the port's network, its SCED against HiGHS, its episodes against
the port's lockstep rollout (``core.batch_rollout``, the plain version of
the solve kernel); the lower-precision control and each planted fault
against the cell's limits; and the spans and counters of the market's
lockstep rollout.

    python -m pytest tests/test_torch_market_reference.py -q
"""
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from h100_bench.lib import spec
from h100_bench.reference import market
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import batch_rollout, random_policy, trace
from sustaingym_tpu_torch.core.graph import Graphs
from sustaingym_tpu_torch.envs.electricitymarket import network

CONFIG = spec.config("market-rts24")
CPU = torch.device("cpu")
B = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run tens of thousands of ops on
    tensors of a few thousand elements, which threads only slow down, and
    far more so beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(seed, batch=B, steps=288):
    """The port's lockstep episode from a generator seeded with ``seed``,
    and the generator's state before it."""
    env, params = make("electricitymarket", device=CPU, **CONFIG["make"])
    gen = torch.Generator(device=CPU).manual_seed(seed)
    state = gen.get_state()
    ts = batch_rollout(env, params, random_policy(env, params, batch), None,
                       gen, batch, steps, graphs=Graphs(CPU))
    return params, state, ts


@pytest.fixture(scope="module")
def episode():
    """One seeded episode of the port at B = 16, and the reference's on the
    same days and bids."""
    params, state, ts = _program(2 ** 31 + 5)
    ref = market.Reference(CONFIG, CPU)
    days, bids = ref.episode_draws(state, B)
    return params, ts, ref, days, bids


def test_reference_lp_is_the_programs_network():
    """The reference builds the SCED from its own tables: the same
    matrices as ``network.build_sced_matrices`` to float64 rounding (the
    PTDF by another factorisation; the port's exact zeros of the PTDF read
    as noise of ~1e-16, which the reference sets to 0), and the same
    preconditioner where that noise does not enter."""
    mats = network.build_sced_matrices(network.build_network(), 4)
    lp = market.sced_lp(4)
    for key in ("A", "ub"):
        np.testing.assert_array_equal(lp[key], mats[key])
    np.testing.assert_allclose(lp["S"], mats["S"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(lp["load_sf"], mats["load_sf"], rtol=0,
                               atol=1e-15)
    net = network.build_network()
    np.testing.assert_array_equal(lp["gen_cost"], net.gen_cost)
    np.testing.assert_array_equal(lp["rating"], net.line_rating)
    assert (lp["ic"], lp["id"]) == (mats["ic"], mats["id"])
    env, params = make("electricitymarket", device=CPU, **CONFIG["make"])
    ref = market.Reference(CONFIG, CPU)
    op = params.op
    for mine, theirs in ((ref.tau, op.tau), (ref.sig_a, op.sigma_a),
                         (ref.A, op.A), (ref.load, params.load),
                         (ref.moer, params.moer[:, :, 0])):
        torch.testing.assert_close(mine, theirs, rtol=0, atol=0)
    # |S|^0.35 lifts the port's 1e-16 noise to ~4e-6 in the row sums
    # (1.2e-5 relative in 4 of the 156 rows)
    torch.testing.assert_close(ref.sig_s, op.sigma_s, rtol=2e-5, atol=0)
    assert [ref.shift["x"].tolist(), ref.shift["y"].tolist()] == [
        params.warm_perm_x.tolist(), params.warm_perm_y.tolist()]
    assert torch.equal(torch.cat([ref.shift["z"], ref.shift["z"] + ref.ms]),
                       params.warm_perm_z)


@pytest.mark.parametrize("state", [
    (0, 0, 40.0, [5.0] * 4 + [500.0] * 4),       # idle: bids out of merit
    (7, 150, 10.0, [900.0] * 4 + [999.0] * 4),   # charges at full power
    (15, 200, 79.0, [10.0] * 4 + [20.0] * 4),    # nearly full
    (30, 250, 60.0, [30.0] * 4 + [12.0] * 4),    # discharges
    (12, 287, 0.5, [300.0, 0.0, 80.0, 1.0, 700.0, 50.0, 999.0, 0.0]),
])
def test_reference_sced_matches_highs(state):
    """At float64 and 10,000 iterations the reference's PDHG is HiGHS's
    LP optimum: the price (minus the balance's dual; HiGHS's marginal of
    the first balance row) and the battery's dispatch to 1e-6, the
    objective to 1e-9 of its size, and the generation of each marginal
    cost class in each interval to 1e-5 MW (units of one cost are
    interchangeable, so their split is not unique). At 2,000 iterations
    the prices were already within 2e-9 and the objective within 3e-8."""
    day, t, e, bid = state
    ref = market.Reference(CONFIG, CPU, dtype=torch.float64)
    days = torch.tensor([day])
    energy = torch.tensor([e], dtype=torch.float64)
    bids = torch.tensor([bid], dtype=torch.float64)
    b, hp, hm = ref.problem(days, t, energy)
    c = ref.costs(bids)

    def zeros(m):
        return torch.zeros((1, m), dtype=torch.float64)
    x, y, _, _ = ref.solve(c, b, hp, hm, (zeros(ref.n), zeros(ref.me),
                                          zeros(ref.ms), zeros(ref.ms)),
                           10_000, "f64")
    lp = ref.lp
    res = linprog(c[0].numpy(), A_ub=np.vstack([lp["S"], -lp["S"]]),
                  b_ub=torch.cat([hp[0], hm[0]]).numpy(), A_eq=lp["A"],
                  b_eq=b[0].numpy(), bounds=[(0, u) for u in lp["ub"]],
                  method="highs")
    assert res.status == 0, res.message
    assert abs(-float(y[0, 0]) - res.eqlin.marginals[0]) < 1e-6
    x = x[0].numpy()
    np.testing.assert_allclose(x[lp["ic"]:], res.x[lp["ic"]:], atol=1e-6)
    assert abs(float(c[0].numpy() @ x) - res.fun) <= 1e-9 * abs(res.fun)
    ng = len(market.UNITS)
    cost = lp["gen_cost"]
    for tau in range(ref.k):
        g, h = x[tau * ng:(tau + 1) * ng], res.x[tau * ng:(tau + 1) * ng]
        for level in np.unique(cost):
            assert abs(g[cost == level].sum() - h[cost == level].sum()) \
                < 1e-5, (tau, level)


def test_reference_episode_follows_the_program(episode):
    """Over one 288-step episode at B = 16 on the bids the port drew: the
    replayed bids are the port's exactly (its obs' ``prev_action``, the
    last step's overwritten by the next reset). The outputs part a little:
    the reference's step sizes differ from the port's by up to 1.2e-5
    relative (the PTDF noise above), which flips bf16 roundings of the
    iterates, and the 40-iteration warm solves carry the flips on: a
    battery decision near its bid can flip, and one env's trajectory parts
    from there. So a step's price may differ by a few $/MWh (2.4 on this
    seed), and the test takes the cell's measures with room over what the
    CPU read on eight seeds at B = 16 and 64: each env's episode totals
    within 0.05 of the column's mean (read up to 0.0104, on this seed), the
    99th percentile of the price gap within 0.03 of the mean price
    (6.1e-3), the final energy within 0.01 of the capacity (2.7e-3)."""
    params, ts, ref, days, bids = episode
    assert torch.equal(ts.obs["prev_action"][:-1], bids[:-1])
    want = ref.episode(days, bids)
    got = torch.stack([ts.reward, ts.info["revenue"],
                       ts.info["carbon_value"]], -1).double()
    ref_cols = torch.stack([want["reward"], want["revenue"],
                            want["carbon_value"]], -1).double()
    scale = ref_cols.sum(0).abs().mean(0)
    scale = torch.maximum(scale, scale[0])
    assert ((got.sum(0) - ref_cols.sum(0)).abs() / scale).max() < 0.05
    gap = (ts.info["price"] - want["price"]).abs().double()
    assert torch.quantile(gap.flatten(), 0.99) < 0.03 * want[
        "price"].abs().mean()
    assert (ts.info["energy_level"][-1] - want["energy_level"][-1]).abs() \
        .max() < 0.01 * market.CAPACITY
    for key in ("dispatch_mwh", "terminal_cost"):
        assert torch.isfinite(want[key]).all()


def test_reference_is_the_programs_math_on_its_operator(episode):
    """Given the port's own paired rows and their step sizes, the
    reference's episode is the port's bit for bit: what parts them above
    is the PTDF's noise alone."""
    params, ts, ref, days, bids = episode
    ref = market.Reference(CONFIG, CPU)
    ref.S, ref.sig_s = params.op.S.clone(), params.op.sigma_s.clone()
    want = ref.episode(days, bids)
    assert torch.equal(ts.reward, want["reward"])
    for key in ("price", "energy_level", "dispatch_mwh", "revenue",
                "carbon_value", "terminal_cost"):
        assert torch.equal(ts.info[key], want[key]), key


@pytest.fixture(scope="module")
def checked():
    """The cell's driver at B = 16 after its comparison: set-up, a short
    window, the check (ready for stand-ins)."""
    mix = dict(spec.traffic("market-4096x288"),
               **spec.small("market-sim")["small"])
    driver = spec.module("traffic", mix["driver"]).Driver(CONFIG, mix, 7,
                                                          CPU)
    driver.setup(False)
    driver.window(0.1)
    driver.release()
    numbers, extras = driver.check(spec.module("reference", "market"))
    return driver, numbers, extras


def test_sound_run_is_within_the_limits(checked):
    driver, numbers, extras = checked
    limits = spec.limits("market-sim")
    assert set(numbers) == set(limits)
    assert all(v <= limits[k] for k, v in numbers.items()), numbers
    assert numbers["bids_gap"] == 0.0
    assert extras["solve_iters"] == [200] + [40] * 287
    assert (extras["n"], extras["me"], extras["ms"]) == (140, 4, 156)


@pytest.mark.parametrize("stand_in", ["control"] + list(
    spec.module("traffic", "market_episodes").STAND_IN_FAULTS))
def test_control_and_each_fault_read_over_a_limit(checked, stand_in):
    """The reference in the program's place with the fp8 e4m3 control's
    operands, or with each fault planted, reads over at least one of the
    cell's limits."""
    driver = checked[0]
    if stand_in == "control":
        got = driver.stand_in(prec=CONFIG["controls"]["market_episodes"])
    else:
        got = driver.stand_in(fault=stand_in)
    limits = spec.limits("market-sim")
    assert any(v > limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("fault,number", [
    ("altered_output", "reward_step_gap"),
    ("frozen_energy", "energy_step_gap"),
    ("half_batch", "energy_step_gap"),
])
def test_step_wise_numbers_catch_what_the_totals_may_not(checked, fault,
                                                          number):
    """The step-wise numbers recompute each step from the outputs' own
    price, dispatch and energy, so they hold the reward's arithmetic and
    the energy update to rounding, where the totals against the reference
    leave room for trajectories that part: one reward +100 $ reads ~0.035
    of ``return_gap``'s 0.5 here, and over ``reward_step_gap``'s limit by
    four orders. The sound run reads float32 rounding (~1e-7) on both."""
    driver, numbers = checked[0], checked[1]
    limits = spec.limits("market-sim")
    assert numbers[number] < 0.01 * limits[number], numbers
    got = driver.stand_in(fault=fault)
    assert got[number] > 100 * limits[number], got
    """Traced, one 300-step call (an episode, then 12 steps of the next):
    a ``market.start`` host span for each episode start (the first, the
    second at the first episode's end), a ``market.episode`` span for each
    episode's step loop, 300 solves and 200 + 287 x 40 + 200 + 11 x 40 =
    12,320 PDHG iterations, and no read of the card. Tracing off, the
    outputs are the same bits and no span is opened."""
    env, params = make("electricitymarket", device=CPU, **CONFIG["make"])
    policy = random_policy(env, params, 2)

    def run():
        gen = torch.Generator(device=CPU).manual_seed(3)
        return batch_rollout(env, params, policy, None, gen, 2, 300,
                             graphs=Graphs(CPU))
    with trace.recording() as rec:
        traced = run()
    snap = rec.snapshot()
    names = [s["name"] for s in snap["spans"]]
    assert names.count("market.start") == 2
    assert names.count("market.episode") == 2
    assert snap["counters"]["market.solves"] == 300
    assert snap["counters"]["market.pdhg_iters"] == 200 + 287 * 40 + 200 \
        + 11 * 40
    assert not [k for k in snap["counters"] if k.startswith("host_syncs")]
    real = trace._Open

    def refuse(*args):
        raise AssertionError("a span opened with tracing off")
    trace._Open = refuse
    try:
        plain = run()
    finally:
        trace._Open = real
    assert torch.equal(plain.reward, traced.reward)
    for key in traced.info:
        assert torch.equal(plain.info[key], traced.info[key]), key


def test_an_episode_counts_288_solves_and_11680_iterations():
    env, params = make("electricitymarket", device=CPU, **CONFIG["make"])
    gen = torch.Generator(device=CPU).manual_seed(4)
    with trace.recording() as rec:
        batch_rollout(env, params, random_policy(env, params, 1), None, gen,
                      1, 288)
    counters = rec.snapshot()["counters"]
    assert counters["market.solves"] == 288
    assert counters["market.pdhg_iters"] == 11_680
