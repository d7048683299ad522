"""The port's Gymnasium and PettingZoo adapters (sustaingym_tpu_torch.
compat): every check of tests/test_compat.py (gymnasium's env_checker,
PettingZoo's parallel_api_test and parallel_seed_test, seed determinism,
the cogen Dict API, the EV round trip, the discrete action wrapper, the
vector env), on the CPU, with the building on the synthetic tables
(envs/building/synthetic.py: the raw OfficeSmall tables are absent).
Checks beyond them: the port's IDs registered beside the JAX package's,
check_env on all five adapters, and the seeded-reset observations of the
EV, market and datacenter adapters against the JAX package's adapters on
the same seeds (bit-equal: both read the same packed data and compute the
reset obs in float32 with the same operations)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import gymnasium
import gymnasium.utils.env_checker
from pettingzoo.test import parallel_api_test, parallel_seed_test

import sustaingym_tpu_torch.compat as compat
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.envs.building import BUILDINGS, synthetic

SMALL_LP = dict(lp_iters=30, lp_warm_iters=10)   # CPU speed


@pytest.fixture(scope="module")
def bkw(tmp_path_factory):
    """Keyword arguments of a building adapter on the synthetic tables."""
    root = str(tmp_path_factory.mktemp("building_tables"))
    htm, epw = synthetic.write_building_tables(root)
    return dict(building=htm, weather=epw, location="Tucson", root=root,
                u_wall=BUILDINGS["OfficeSmall"][1], device="cpu")


@pytest.fixture(scope="module")
def building_env(bkw):
    return compat.BuildingGymEnv(**bkw)


def test_gym_registration(bkw):
    """The port's five IDs make its adapters; the JAX package's IDs stay
    registered to the JAX package's classes (both packages in one
    process)."""
    import sustaingym_tpu.compat  # noqa: F401  registers sustaingym/*
    import sustaingym_tpu_torch.compat as again
    again._register()
    from gymnasium.envs.registration import registry
    for env_id, cls in compat.ENV_IDS.items():
        assert registry[env_id].entry_point == (
            f"sustaingym_tpu_torch.compat.gym:{cls}")
        jax_id = env_id.replace("sustaingym_torch/", "sustaingym/")
        assert registry[jax_id].entry_point.startswith(
            "sustaingym_tpu.compat.gym:")
    env = gymnasium.make("sustaingym_torch/Building-v0", **bkw)
    obs, info = env.reset(seed=0)
    assert obs.shape == (10,) and obs.dtype == np.float32
    env.close()
    env = gymnasium.make("sustaingym_torch/EVCharging-v0", device="cpu")
    assert isinstance(env.unwrapped, compat.EVChargingGymEnv)
    env.close()


@pytest.mark.parametrize("name", ["building", "cogen", "evcharging",
                                  "electricitymarket", "datacenter"])
def test_check_env(name, bkw):
    """gymnasium's env_checker on each adapter (the JAX tests run it on the
    building one)."""
    env = {"building": lambda: compat.BuildingGymEnv(**bkw),
           "cogen": lambda: compat.CogenGymEnv(forecast_horizon=2,
                                               device="cpu"),
           "evcharging": lambda: compat.EVChargingGymEnv(device="cpu"),
           "electricitymarket": lambda: compat.ElectricityMarketGymEnv(
               device="cpu", **SMALL_LP),
           "datacenter": lambda: compat.DataCenterGymEnv(device="cpu")}[name]()
    gymnasium.utils.env_checker.check_env(env, skip_render_check=True)


def test_building_seed_determinism(building_env):
    obs1, _ = building_env.reset(seed=42)
    r1 = [building_env.step(np.zeros(6, np.float32))[1] for _ in range(5)]
    obs2, _ = building_env.reset(seed=42)
    r2 = [building_env.step(np.zeros(6, np.float32))[1] for _ in range(5)]
    np.testing.assert_allclose(obs1, obs2)
    np.testing.assert_allclose(r1, r2)


def test_cogen_gym_dict_api():
    env = compat.CogenGymEnv(forecast_horizon=2, device="cpu")
    obs, info = env.reset(seed=3)
    assert set(obs.keys()) == {"Time", "Prev_Action", "TAMB", "PAMB", "RHAMB",
                               "Target_Power", "Target_Steam", "Energy_Price",
                               "Gas_Price"}
    assert isinstance(obs["Prev_Action"], dict)
    assert obs in env.observation_space
    action = env.action_space.sample()
    obs, r, term, trunc, info = env.step(action)
    assert np.isfinite(r)
    assert "fuel_costs" in info


def test_evcharging_gym_roundtrip():
    env = compat.EVChargingGymEnv(device="cpu")
    obs, info = env.reset(seed=0)
    assert set(obs.keys()) == {"timestep", "est_departures", "demands",
                               "prev_moer", "forecasted_moer"}
    a = np.ones(54, np.float32)
    for _ in range(3):
        obs, r, term, trunc, info = env.step(a)
    assert "reward_breakdown" in info
    assert set(info["reward_breakdown"]) == {"profit", "carbon_cost",
                                             "excess_charge"}


@pytest.mark.parametrize("name,seeds", [
    ("evcharging", (0, 5, 1000)), ("electricitymarket", (0, 7, 95)),
    ("datacenter", (0, 3, 40))])
def test_seeded_reset_matches_jax_adapter(name, seeds):
    """A seeded reset gives the JAX adapter's obs, bit for bit (EV, market
    and datacenter: seed -> day or month, then the same packed rows)."""
    import sustaingym_tpu.compat as jcompat
    cls = {"evcharging": "EVChargingGymEnv",
           "electricitymarket": "ElectricityMarketGymEnv",
           "datacenter": "DataCenterGymEnv"}[name]
    kw = SMALL_LP if name == "electricitymarket" else {}
    jenv = getattr(jcompat, cls)(**kw)
    tenv = getattr(compat, cls)(device="cpu", **kw)
    for seed in seeds:
        jobs, _ = jenv.reset(seed=seed)
        tobs, _ = tenv.reset(seed=seed)
        if not isinstance(jobs, dict):
            jobs, tobs = {"obs": jobs}, {"obs": tobs}
        assert set(jobs) == set(tobs)
        for k in jobs:
            np.testing.assert_array_equal(tobs[k], np.asarray(jobs[k]),
                                          err_msg=f"{name} seed {seed} {k}")


def test_discrete_action_wrapper(building_env):
    wrapped = compat.DiscreteActionWrapper(building_env, bins=5)
    assert isinstance(wrapped.action_space, gymnasium.spaces.MultiDiscrete)
    a = wrapped.action_space.sample()
    cont = wrapped.action(a)
    assert np.all(cont >= 0) and np.all(cont <= 1)
    np.testing.assert_allclose(cont, np.asarray(a) / 4.0)


# ---------------------------------------------------------------------------
# PettingZoo
# ---------------------------------------------------------------------------

def test_ma_building_parallel_api(bkw):
    # 1000 cycles: the reference's rigor, spanning episode boundaries
    env = compat.MultiAgentBuildingParallelEnv(**bkw)
    parallel_api_test(env, num_cycles=1000)


def test_ma_cogen_parallel_api():
    env = compat.MultiAgentCogenParallelEnv(forecast_horizon=2, device="cpu")
    parallel_api_test(env, num_cycles=1000)


def test_ma_evcharging_parallel_api():
    env = compat.MultiAgentEVChargingParallelEnv(device="cpu")
    parallel_api_test(env, num_cycles=1000)


def test_ma_parallel_seed_determinism(bkw):
    """pettingzoo's parallel_seed_test on all three MA adapters: the same
    seed gives the same episodes."""
    parallel_seed_test(lambda: compat.MultiAgentBuildingParallelEnv(**bkw))
    parallel_seed_test(lambda: compat.MultiAgentCogenParallelEnv(
        forecast_horizon=2, device="cpu"))
    parallel_seed_test(
        lambda: compat.MultiAgentEVChargingParallelEnv(device="cpu"))


def test_ma_evcharging_discrete_parallel_api():
    """Discrete-action MA EV (the bins mapped inside the view, as the
    reference's MultiAgentEVChargingEnv(discrete_bins=5))."""
    env = compat.MultiAgentEVChargingParallelEnv(discrete_bins=5,
                                                 device="cpu")
    assert isinstance(env.action_spaces[env.possible_agents[0]],
                      gymnasium.spaces.Discrete)
    parallel_api_test(env, num_cycles=500)


def test_ma_evcharging_discrete_matches_continuous():
    """Discrete action k equals continuous action k / (bins - 1) exactly,
    through the adapters."""
    envs = [compat.MultiAgentEVChargingParallelEnv(
        discrete_bins=bins, project_action=False, device="cpu")
        for bins in (5, -1)]
    outs = []
    for env, value in zip(envs, (3, 3 / 4.0)):
        env.reset(seed=3)
        dtype = np.int64 if value == 3 else np.float32
        outs.append(env.step({a: np.asarray(value, dtype)
                              for a in env.agents}))
    for a in envs[0].possible_agents:
        assert outs[0][1][a] == outs[1][1][a]
        np.testing.assert_array_equal(outs[0][0][a], outs[1][0][a])


def test_ma_evcharging_periods_delay():
    env = compat.MultiAgentEVChargingParallelEnv(periods_delay=2,
                                                 device="cpu")
    obss, _ = env.reset(seed=0)
    assert len(obss) == 54
    actions = {a: np.ones(1, np.float32) for a in env.agents}
    for _ in range(4):
        obss, rewards, terms, truncs, infos = env.step(actions)
    # the reward is split evenly across agents
    vals = list(rewards.values())
    assert np.allclose(vals, vals[0])


def test_ma_cogen_reward_decomposition():
    env = compat.MultiAgentCogenParallelEnv(forecast_horizon=2, device="cpu")
    obss, _ = env.reset(seed=1)
    actions = {a: env.action_spaces[a].sample() for a in env.agents}
    obss, rewards, terms, truncs, infos = env.step(actions)
    assert set(rewards) == {"GT1", "GT2", "GT3", "ST"}
    assert all(np.isfinite(v) for v in rewards.values())


# ---------------------------------------------------------------------------
# Vectorized gymnasium adapter (one batch on the device)
# ---------------------------------------------------------------------------

def test_vector_env_building(bkw):
    """Steps past the episode's end: the done envs come back reset in the
    same step (same-step autoreset)."""
    venv = compat.make_vec("building", num_envs=8, seed=0, **bkw)
    obs, info = venv.reset(seed=0)
    assert obs.shape == (8,) + venv.single_observation_space.shape
    a = venv.action_space.sample()
    obs, r, term, trunc, info = venv.step(a)
    assert r.shape == (8,) and term.shape == (8,)
    assert np.all(np.isfinite(r))
    ends = 0
    for _ in range(venv.params.episode_len):
        obs, r, term, trunc, info = venv.step(a)
        ends += int((term | trunc).sum())
    assert ends == 8
    assert np.all(np.isfinite(obs))


def test_vector_env_dict_obs():
    venv = compat.make_vec("evcharging", num_envs=4, seed=1,
                           project_action=False, device="cpu")
    obs, _ = venv.reset(seed=1)
    assert isinstance(obs, dict)
    assert obs["demands"].shape == (4, venv.params.n_stations)
    a = np.random.default_rng(0).uniform(
        0, 1, (4, venv.params.n_stations)).astype(np.float32)
    obs, r, term, trunc, info = venv.step(a)
    assert r.shape == (4,)
    assert "excess_charge" in info


def test_vector_env_matches_single(bkw):
    """A vector env of one reproduces the env's own reset from the same
    generator seed."""
    venv = compat.make_vec("building", num_envs=1, seed=5, **bkw)
    obs, _ = venv.reset(seed=5)
    env, params = make("building", **bkw)
    _, ts = env.reset(params, torch.Generator().manual_seed(5), 1)
    np.testing.assert_array_equal(obs[0], ts.obs[0].numpy())


@pytest.mark.parametrize("factory", [
    lambda kw: compat.EVChargingGymEnv(),
    lambda kw: compat.CogenGymEnv(),
    lambda kw: compat.ElectricityMarketGymEnv(),
    lambda kw: compat.DataCenterGymEnv(),
    lambda kw: compat.BuildingGymEnv(**kw),
    lambda kw: compat.make_vec("evcharging", 4),
    lambda kw: compat.MultiAgentBuildingParallelEnv(**kw),
    lambda kw: compat.MultiAgentCogenParallelEnv(),
    lambda kw: compat.MultiAgentEVChargingParallelEnv()])
def test_adapters_default_to_the_card(factory, bkw):
    """Every adapter builds its env on the card unless asked for the CPU;
    without a card the default raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    kw = {k: v for k, v in bkw.items() if k != "device"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory(kw)
