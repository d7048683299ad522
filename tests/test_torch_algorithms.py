"""The port's baseline algorithms (sustaingym_tpu_torch.algorithms) and
building's data-driven fit, on the CPU: every check of
tests/test_algorithms.py (the runner, MPC at least on par with greedy,
offline-optimal feasible and at least on par with MPC, building MPC on the
physics and the identified dynamics beating the zero action, batch_run's
seed semantics, the random baseline), the building ones on the synthetic
tables (envs/building/synthetic.py). Against the JAX package on the same
day, seeds and inputs:

- the greedy episode return, rtol 2e-4: the EV step's parity bound
  (tests/test_torch_evcharging.py), float32 sums in another order;
- MPC's first action, atol 2e-3: 400 PDHG iterations whose float32
  products sum in another order (pilots in [0, 1]);
- ``offline_optimal_schedule``, atol 2e-3 on pilots in [0, 1], the same
  reason over 2000 iterations;
- ``fit_data_driven``'s coefficients, rtol 1e-9: one ``nnls`` per zone on
  the same float64 design matrix (sklearn's LinearRegression(positive=
  True) solves the same problems; only the solver's own rounding
  differs);
- ``batch_run``'s returns, rtol 2e-5 / atol 2e-4: the building parity
  bound (tests/test_torch_building.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import sustaingym_tpu_torch.compat as compat
from sustaingym_tpu_torch import algorithms as algos
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.algorithms.evcharging import (
    day_sessions, offline_optimal_schedule)
from sustaingym_tpu_torch.envs.building import (BUILDINGS, fit_data_driven,
                                                synthetic)
from sustaingym_tpu_torch.envs.evcharging.env import (A_PERS_TO_KWH,
                                                      ACTION_SCALE_FACTOR,
                                                      MAX_TIMESTEP)

MPC_KW = dict(lookahead=12, lp_iters=400)


@pytest.fixture(scope="module")
def ev_env():
    return compat.EVChargingGymEnv(device="cpu")


@pytest.fixture(scope="module")
def busy_seed(ev_env):
    return int(torch.argmax(ev_env.params.day_num_evs))


@pytest.fixture(scope="module")
def jax_ev_env():
    import sustaingym_tpu.compat as jcompat
    return jcompat.EVChargingGymEnv()


@pytest.fixture(scope="module")
def greedy_return(ev_env, busy_seed):
    return algos.GreedyAlgorithm(ev_env).run([busy_seed])["return"].iloc[0]


@pytest.fixture(scope="module")
def mpc_return(ev_env, busy_seed):
    """One MPC episode, shared by the two checks that compare with it."""
    return algos.MPC(ev_env, **MPC_KW).run([busy_seed])["return"].iloc[0]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("building_tables"))
    htm, epw = synthetic.write_building_tables(root)
    return dict(building=htm, weather=epw, location="Tucson", root=root,
                u_wall=BUILDINGS["OfficeSmall"][1])


def _jax_building(tables):
    from sustaingym_tpu.envs import building as jb
    return jb.make_env(**tables)


def test_greedy_runner(ev_env, busy_seed, greedy_return, jax_ev_env):
    import sustaingym_tpu.algorithms as jalgos
    df = algos.GreedyAlgorithm(ev_env).run([busy_seed])
    assert set(df.columns) >= {"seed", "return"}
    assert df["return"].iloc[0] > 0
    assert df["return"].iloc[0] == greedy_return
    assert busy_seed == int(np.argmax(
        np.asarray(jax_ev_env.params.ev_mask).sum(axis=1)))
    jret = jalgos.GreedyAlgorithm(jax_ev_env).run([busy_seed])["return"]
    np.testing.assert_allclose(greedy_return, jret.iloc[0], rtol=2e-4)


def test_mpc_beats_greedy_on_carbon(greedy_return, mpc_return):
    # MPC optimizes profit - carbon; it must do at least on par with greedy
    assert mpc_return > greedy_return - 0.25, (mpc_return, greedy_return)


def test_mpc_first_action_matches_jax(ev_env, busy_seed, jax_ev_env):
    import sustaingym_tpu.algorithms as jalgos
    obs, _ = ev_env.reset(seed=busy_seed)
    jobs, _ = jax_ev_env.reset(seed=busy_seed)
    # a step with plugged-in cars, so the LP has demands to schedule
    for _ in range(100):
        a = np.ones(54, np.float32) * 0.25
        obs = ev_env.step(a)[0]
        jobs = jax_ev_env.step(a)[0]
    assert obs["demands"].sum() > 0
    got = algos.MPC(ev_env, **MPC_KW).get_action(obs)
    want = np.asarray(jalgos.MPC(jax_ev_env, **MPC_KW).get_action(jobs))
    assert got.shape == (54,) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_offline_optimal_schedule_feasible(ev_env, busy_seed, jax_ev_env):
    from sustaingym_tpu.algorithms.evcharging import (
        offline_optimal_schedule as joffline)
    params = ev_env.params
    traj = offline_optimal_schedule(params, busy_seed, iters=2000).numpy()
    assert traj.shape == (MAX_TIMESTEP, params.n_stations)
    assert traj.min() >= -1e-5 and traj.max() <= 1.0 + 1e-5
    # respects each session's demand cap (in A-periods)
    for a, st, d, req in zip(*day_sessions(params, busy_seed)):
        delivered = traj[int(a):int(d), st].sum()
        cap = req / A_PERS_TO_KWH / ACTION_SCALE_FACTOR
        assert delivered <= cap * 1.02 + 1e-3
    # the same sessions as the JAX params' ev_data
    jp = jax_ev_env.params
    msk = np.asarray(jp.ev_mask)[busy_seed]
    assert len(day_sessions(params, busy_seed)[0]) == int(msk.sum())
    want = joffline(jp, busy_seed, iters=2000)
    np.testing.assert_allclose(traj, want, rtol=0, atol=2e-3)


def test_offline_optimal_beats_mpc(ev_env, busy_seed, mpc_return):
    o = algos.OfflineOptimal(ev_env, iters=3000).run(
        [busy_seed])["return"].iloc[0]
    assert o > mpc_return - 0.3, (o, mpc_return)


def test_building_mpc_beats_zero_action(tables):
    env = compat.BuildingGymEnv(device="cpu", **tables)
    obs, _ = env.reset(seed=150)
    zero_ret = 0.0
    for _ in range(50):
        _, r, *_ = env.step(np.zeros(6, np.float32))
        zero_ret += r
    agent = algos.MPCAgent(env, iters=200)
    obs, _ = env.reset(seed=150)
    mpc_ret = 0.0
    for _ in range(50):
        a = agent.get_action(obs)
        obs, r, *_ = env.step(a.astype(np.float32))
        mpc_ret += r
    assert mpc_ret > zero_ret, (mpc_ret, zero_ret)


def _trajectory(env, params, steps=300, epoch=1000):
    """A physics-model trajectory under uniform random actions (numpy,
    seed 0): (states (steps + 1, n), actions in watts (steps, n))."""
    state, _ = env.reset_at_epoch(params, [epoch])
    states, actions = [state.x[0].numpy()], []
    rng = np.random.default_rng(0)
    for _ in range(steps):
        a = rng.uniform(-1, 1, params.n).astype(np.float32)
        state, _ = env.step(params, state, torch.from_numpy(a)[None])
        states.append(state.x[0].numpy())
        actions.append(a * params.max_power)
    return np.asarray(states), np.asarray(actions)


def test_fit_data_driven_matches_jax(tables):
    """The identified A_d / BD_d equal the JAX package's (sklearn) fit on
    the same trajectory, and the fitted params switch to the data-driven
    input layout."""
    from sustaingym_tpu.envs.building import fit_data_driven as jfit
    env, params = make("building", device="cpu", **tables)
    _, jparams = _jax_building(tables)
    states, actions = _trajectory(env, params)
    dd = fit_data_driven(params, states, actions, start_epoch=1000)
    jdd = jfit(jparams, states, actions, start_epoch=1000)
    assert dd.data_driven and dd.BD_d.shape == (params.n, params.n + 7)
    assert float(dd.A_d.min()) >= 0 and float(dd.BD_d.min()) >= 0
    for name in ("A_d", "BD_d"):
        np.testing.assert_allclose(getattr(dd, name).numpy(),
                                   np.asarray(getattr(jdd, name)),
                                   rtol=1e-9, atol=0, err_msg=name)


def test_building_mpc_data_driven_beats_zero_action(tables):
    """MPC planning on IDENTIFIED dynamics: the counterpart of the
    reference's MPCAgent_DataDriven, whose predictor input is the n + 7
    layout [avg^2, avg, meta^2, meta, ground, out, u(n), ghi]."""
    env, params = make("building", device="cpu", **tables)
    dd = fit_data_driven(params, *_trajectory(env, params), start_epoch=1000)

    def rollout(policy_fn):
        s, _ = env.reset_at_epoch(dd, [2000])
        total = 0.0
        for _ in range(40):
            s, ts = env.step(dd, s, policy_fn(s)[None])
            total += float(ts.reward[0])
        return total

    zero_ret = rollout(lambda s: torch.zeros(params.n))
    mpc_ret = rollout(lambda s: algos.mpc_action(dd, s.x[0], s.epoch[0],
                                                 iters=200))
    assert mpc_ret > zero_ret, (mpc_ret, zero_ret)


def test_batch_run_matches_seed_semantics(tables):
    """batch_run steps all seeds in lockstep from their seeded resets (seed
    -> epoch); each seed's return equals the JAX package's batch_run and
    a seed run alone."""
    import jax.numpy as jnp
    from sustaingym_tpu.algorithms.base import batch_run as jbatch_run
    env, params = make("building", device="cpu", **tables)

    def zero_policy(obs, generator):
        return torch.zeros((obs.shape[0], params.n))

    seeds = [0, 1, 2]
    df = algos.batch_run(env, params, zero_policy, seeds=seeds,
                         num_steps=params.episode_len)
    assert len(df) == 3 and list(df["seed"]) == seeds
    assert np.all(np.isfinite(df["return"]))
    alone = algos.batch_returns(env, params, zero_policy, [2],
                                params.episode_len)
    np.testing.assert_allclose(float(alone[0]), df["return"].iloc[2],
                               rtol=1e-6)
    jenv, jparams = _jax_building(tables)
    jdf = jbatch_run(jenv, jparams, lambda obs, key: jnp.zeros(params.n),
                     seeds=seeds, num_steps=params.episode_len)
    np.testing.assert_allclose(df["return"], jdf["return"], rtol=2e-5,
                               atol=2e-4)


def test_random_algorithm_runs(ev_env, busy_seed):
    df = algos.EVRandomAlgorithm(ev_env).run([busy_seed])
    assert np.isfinite(df["return"].iloc[0])
    df = algos.RandomAlgorithm(ev_env).run([busy_seed])
    assert np.isfinite(df["return"].iloc[0])
