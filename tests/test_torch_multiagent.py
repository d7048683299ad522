"""PyTorch port of the multi-agent views (sustaingym_tpu_torch.envs.
multiagent) and their PPO paths, against the JAX package's views and
learner functions on the same numpy-seeded inputs.

Tolerances, each with its reason:
- MA-EV: rewards and info rtol 2e-5 / atol 1e-6 (the port's EV lockstep
  bound, tests/test_torch_evcharging.py:279); obs the same within the
  port, and against the JAX package rtol 2e-5 / atol 2e-5: demands that
  charge to zero keep a residue of their last rounding (~1e-6, not the
  same in both packages; tests/test_torch_evcharging.py::test_batch_
  unroll_matches_jax's bound);
- MA cogen: rewards and costs rtol 2e-5 / atol 0.2, obs rtol 1e-6 / atol
  1e-5 (tests/test_torch_cogen.py's SIM / OBS: relus at active constraint
  boundaries times the 1000 penalties amplify float reassociation);
- MA building: rtol 2e-5 / atol 2e-4 (the building kernels' bound; the RC
  product is a matmul in both packages, summed in other orders);
- the stacked per-agent apply, log-prob and entropy: rtol 1e-5 / atol 1e-5
  (tests/test_torch_ppo.py::test_policy_apply_and_logp_match_jax);
- the uniform-obs path against the agent-axis path: rtol 2e-4 / atol 1e-6
  (tests/test_ppo.py::test_uma_fast_path_matches_generic_ma).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.core import flatten as jflatten
from sustaingym_tpu.envs import building as jb
from sustaingym_tpu.envs import cogen as jcogen
from sustaingym_tpu.envs import multiagent as jma
from sustaingym_tpu.parallel import ppo as jppo
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import batch_rollout, random_policy
from sustaingym_tpu_torch.envs import building as tb
from sustaingym_tpu_torch.envs import multiagent as tma
from sustaingym_tpu_torch.envs.building import synthetic
from sustaingym_tpu_torch.parallel import (PPOConfig, from_jax,
                                           make_train_step, per_agent_apply,
                                           to_jax)
from sustaingym_tpu_torch.parallel import ppo as tppo

EV = dict(rtol=2e-5, atol=1e-6)
EV_OBS = dict(rtol=2e-5, atol=2e-5)
SIM = dict(rtol=2e-5, atol=0.2)
OBS = dict(rtol=1e-6, atol=1e-5)
BLD = dict(rtol=2e-5, atol=2e-4)
L_EV = 288


# ---------------------------------------------------------------------------
# MA-EV view
# ---------------------------------------------------------------------------

def _ma_ev_policy(xp, n, bins):
    """A deterministic policy of the per-agent obs (B, n, D) that the two
    packages compute alike: a ramp over stations in time, plus the count of
    plugged stations in each agent's row (est_departures, which the
    staleness ring delays) / 4096; with ``bins`` the bins (t + station) mod
    bins. Only integers and power-of-two fractions enter besides the ramp."""
    ramp = np.linspace(0.05, 0.95, n).astype(np.float32)

    def policy(_, obs, *rest):
        if bins:
            t = xp.round(obs[:, :, 0] * L_EV)
            a = (t + xp.asarray(np.arange(n, dtype=np.float32))[None]) % bins
            return a.astype(xp.int32) if xp is jnp else a.long()
        plugged = xp.sum((obs[:, :, 1:1 + n] > 0).astype(obs.dtype)
                         if xp is jnp else (obs[:, :, 1:1 + n] > 0).float(),
                         -1)
        a = (xp.asarray(ramp)[None] * (0.5 + obs[:, :, 0])
             + obs[:, :, 1 + 2 * n] + plugged / 4096.0)
        return xp.clip(a, 0.0, 1.0)

    return policy


@pytest.mark.parametrize("delay,bins", [(0, 0), (2, 0), (0, 5)])
def test_ma_ev_batch_unroll_matches_jax(delay, bins):
    """The view's lockstep batch_unroll against the JAX view's, on the
    days the JAX key draws (the first episode's and the autoreset's at
    step 287), a deterministic policy of the per-agent obs, 288 + 4 steps
    across the episode boundary (the reset re-seeds the ring), projection
    off: obs (B, n, D), rewards (B, n), done and info."""
    jenv, jp = jma.MultiAgentEVChargingEnv(), jma.make_ma_ev_params(
        periods_delay=delay, discrete_bins=bins, project_action=False)
    env, p = make("evcharging-multiagent", periods_delay=delay,
                  discrete_bins=bins, project_action=False, device="cpu")
    n = p.base.n_stations
    B, T = 3, L_EV + 4
    key = jax.random.PRNGKey(11)
    want = jenv.batch_unroll(jp, _ma_ev_policy(jnp, n, bins), None, key, B,
                             T)
    key_init, key_scan = jax.random.split(key)
    days0 = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), 0, jp.base.n_days))(jax.random.split(key_init, B)))
    _, key_env = jax.random.split(jax.random.split(key_scan, T)[L_EV - 1])
    days1 = np.asarray(jenv.base._autoreset_days(jp.base, key_env, B))
    got = env.batch_unroll(p, _ma_ev_policy(torch, n, bins), None, B, T,
                           days=torch.from_numpy(np.stack([days0, days1])))
    assert got.obs.shape == (T, B, n, 2 + 2 * n + 36)
    assert got.reward.shape == (T, B, n)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs),
                               **EV_OBS)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward),
                               **EV)
    np.testing.assert_array_equal(got.terminated.numpy(),
                                  np.asarray(want.terminated))
    for k in ("profit", "carbon_cost", "excess_charge", "max_profit"):
        np.testing.assert_allclose(got.info[k].numpy(),
                                   np.asarray(want.info[k]), **EV, err_msg=k)
    assert float(got.info["profit"].sum()) > 0
    # every agent gets the global reward / n
    torch.testing.assert_close(got.reward.sum(-1), got.reward[..., 0] * n)
    # the agents' rows differ (with a delay) where other stations changed
    # within the delay, else they are the one global row
    same = torch.equal(got.obs, got.obs[:, :, :1].expand_as(got.obs))
    assert same == (delay == 0)


@pytest.mark.parametrize("delay", [0, 2])
def test_ma_ev_step_matches_jax(delay):
    """reset_at_day and 24 generic steps from the clock set to 08:00 (when
    sessions arrive and the ring's stale rows differ from the current
    ones) against the JAX view's vmapped step, on prescribed actions."""
    jenv, jp = jma.MultiAgentEVChargingEnv(), jma.make_ma_ev_params(
        periods_delay=delay, project_action=False)
    env, p = make("evcharging-multiagent", periods_delay=delay,
                  project_action=False, device="cpu")
    n, B, T = p.base.n_stations, 32, 24
    rng = np.random.default_rng(3)
    days = rng.integers(0, p.base.n_days, B)
    acts = rng.uniform(0, 1, (T, B, n, 1)).astype(np.float32)
    jst, jts = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    jst = jst.replace(base=jst.base.replace(t=jnp.full((B,), 96, jnp.int32)))
    st, ts = env.reset_at_day(p, torch.from_numpy(days))
    st.base.t.fill_(96)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), **EV_OBS)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    for t in range(T):
        jst, jts = vstep(jp, jst, jnp.asarray(acts[t]), jax.random.PRNGKey(0))
        st, ts = env.step(p, st, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs),
                                   **EV_OBS, err_msg=f"obs at {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward),
                                   **EV, err_msg=f"reward at {t}")
        np.testing.assert_allclose(st.past_obs.numpy(),
                                   np.asarray(jst.past_obs), **EV_OBS)
    assert st.base.plugged.any()


@pytest.mark.parametrize("delay", [0, 2])
def test_ma_ev_batch_unroll_matches_generic(delay):
    """The view's lockstep batch_unroll against batch_rollout(fast=False)
    (the view's step under autoreset) from one generator seed, 288 + 4
    steps, random policy: the same reset draws in the same order, so the
    same trajectories (tests/test_evcharging.py::test_ma_batch_unroll_
    matches_generic's bound)."""
    env, p = make("evcharging-multiagent", periods_delay=delay,
                  project_action=False, device="cpu")
    B, T = 3, L_EV + 4
    policy = random_policy(env, p, B)
    fast = env.batch_unroll(p, policy, None, B, T,
                            torch.Generator().manual_seed(7))
    slow = batch_rollout(env, p, policy, None,
                         torch.Generator().manual_seed(7), B, T, fast=False)
    np.testing.assert_allclose(fast.reward.numpy(), slow.reward.numpy(), **EV)
    np.testing.assert_array_equal(fast.terminated.numpy(),
                                  slow.terminated.numpy())
    np.testing.assert_allclose(fast.obs.numpy(), slow.obs.numpy(), **EV)
    for k in slow.info:
        np.testing.assert_allclose(fast.info[k].numpy(),
                                   slow.info[k].numpy(), **EV, err_msg=k)
    assert fast.terminated[L_EV - 1].all()


def test_ma_ev_spaces_and_params():
    env, p = make("evcharging-multiagent", discrete_bins=5, device="cpu")
    jenv, jp = jma.MultiAgentEVChargingEnv(), jma.make_ma_ev_params(
        discrete_bins=5)
    space, jspace = env.action_space(p), jenv.action_space(jp)
    np.testing.assert_array_equal(space.nvec, jspace.nvec)
    assert env.action_space(make("evcharging-multiagent",
                                 device="cpu")[1]).shape == (54, 1)
    assert not env.uniform_agent_obs(p)
    with pytest.raises(ValueError, match="discrete_bins"):
        tma.make_ma_ev_params(discrete_bins=1, device="cpu")


# ---------------------------------------------------------------------------
# MA cogen view
# ---------------------------------------------------------------------------

LOW = jcogen.env.ACTION_LOW.astype(np.float32)
HIGH = jcogen.env.ACTION_HIGH.astype(np.float32)


@pytest.fixture(scope="module")
def cogen_both():
    kw = dict(forecast_horizon=3, forecast_noise_std=0.0)
    _, jp = jcogen.make_env(**kw)
    env, p = make("cogen-multiagent", device="cpu", **kw)
    return (jma.MultiAgentCogenEnv(), jp), (env, p)


def _padded(flat):
    """(..., 15) flat actions in the (..., 4, 4) padded layout, the padding
    filled with 123 (which the env must ignore)."""
    out = np.full(flat.shape[:-1] + (4, 4), 123.0, np.float32)
    for a, agent in enumerate(tma.COGEN_AGENTS):
        for j, k in enumerate(tma.COGEN_AGENT_ACTION_IDX[agent]):
            out[..., a, j] = flat[..., k]
    return out


def test_ma_cogen_step_matches_jax(cogen_both):
    """The view's step on padded actions against the JAX view's vmapped
    step, 98 steps across the 96-step boundary (reset_at_day at step 95 in
    both), prescribed days and previous actions; per-agent rewards sum to
    the base env's reward."""
    (jenv, jp), (env, p) = cogen_both
    rng = np.random.default_rng(5)
    B, T = 6, 98
    days = rng.integers(0, p.n_days - 1, (2, B))
    prev = LOW + rng.uniform(0, 1, (2, B, 15)).astype(np.float32) * (
        HIGH - LOW)
    flat = LOW + rng.uniform(0, 1, (T, B, 15)).astype(np.float32) * (
        HIGH - LOW)
    acts = _padded(flat)
    k = jax.random.PRNGKey(0)

    def jreset(ep):
        st, _ = jax.vmap(jenv.base.reset_at_day, in_axes=(None, 0, None,
                                                          None))(
            jp, jnp.asarray(days[ep], jnp.int32), k, k)
        return st.replace(prev_action=jnp.asarray(prev[ep]))

    def treset(ep):
        return env.reset_at_day(p, torch.from_numpy(days[ep]),
                                prev_action=torch.from_numpy(prev[ep]))

    jst = jreset(0)
    st, ts = treset(0)
    jflat = jax.vmap(lambda o: jflatten(jenv.observation_space(jp), o))
    want0 = jflat(jax.vmap(jenv.base._obs, in_axes=(None, 0, None, 0))(
        jp, jst, k, jst.slab))
    assert ts.obs.shape == (B, 4, want0.shape[-1])
    assert torch.equal(ts.reward, torch.zeros(B, 4))
    np.testing.assert_allclose(ts.obs[:, 2].numpy(), np.asarray(want0), **OBS)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    for t in range(T):
        jst, jts = vstep(jp, jst, jnp.asarray(acts[t]), k)
        base_st = st
        st, ts = env.step(p, st, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward),
                                   **SIM, err_msg=f"reward at {t}")
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), **OBS,
                                   err_msg=f"obs at {t}")
        for key in jts.info:
            np.testing.assert_allclose(ts.info[key].numpy(),
                                       np.asarray(jts.info[key]), **SIM,
                                       err_msg=key)
        np.testing.assert_array_equal(ts.terminated.numpy(),
                                      np.asarray(jts.terminated))
        _, base = env.base.step(p, base_st, torch.from_numpy(flat[t]))
        np.testing.assert_allclose(ts.reward.sum(-1).numpy(),
                                   base.reward.numpy(), **SIM)
        if t == 95:
            assert ts.terminated.all()
            jst = jreset(1)
            st, _ = treset(1)


def test_ma_cogen_padded_layout_round_trip(cogen_both):
    """The padded (B, 4, 4) action equals the flat 15-vector and the one
    assemble_action builds from per-agent sub-actions (the padding is
    ignored; tests/test_ppo.py::test_cogen_padded_action_equals_flat_
    action); the padded space and mask match the JAX view's."""
    (jenv, jp), (env, p) = cogen_both
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset(p, gen, 4)
    flat = env.base.sample_action(p, gen, 4)
    padded = torch.from_numpy(_padded(flat.numpy()))
    agents = {a: flat[:, list(idx)]
              for a, idx in tma.COGEN_AGENT_ACTION_IDX.items()}
    assert torch.equal(env.assemble_action(agents), flat)
    _, ts_flat = env.step(p, st, flat)
    _, ts_pad = env.step(p, st, padded)
    assert torch.equal(ts_flat.reward, ts_pad.reward)
    assert torch.equal(ts_flat.obs, ts_pad.obs)
    space, jspace = env.padded_action_space(p), jenv.padded_action_space(jp)
    np.testing.assert_array_equal(space.low, jspace.low)
    np.testing.assert_array_equal(space.high, jspace.high)
    np.testing.assert_array_equal(env.action_pad_mask(),
                                  jenv.action_pad_mask())
    for agent in tma.COGEN_AGENTS:
        np.testing.assert_array_equal(
            env.agent_action_space(p, agent).low,
            jenv.agent_action_space(jp, agent).low)


# ---------------------------------------------------------------------------
# MA building view
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def building_params(tmp_path_factory):
    """Both packages' params of the 6-zone synthetic office, compiled from
    the same files (tests/test_torch_building.py), episodes of 10 steps."""
    root = str(tmp_path_factory.mktemp("ma_building_tables"))
    htm, epw = synthetic.write_building_tables(root)
    kw = dict(u_wall=jb.BUILDINGS["OfficeSmall"][1], root=root)
    jd = jb.generate_building_params(htm, epw, "Tucson", **kw)
    td = tb.generate_building_params(htm, epw, "Tucson", **kw)
    jd["episode_len"] = td["episode_len"] = 10
    return (jb.make_params(jd, dtype=jnp.float32),
            tb.make_params(td, device="cpu"), (htm, epw, root))


def test_ma_building_step_matches_jax(building_params):
    """reset_at_epoch and 13 steps of (B, n_agents, 1) actions across the
    10-step episode end (reset_at_epoch at step 9 in both), against the
    JAX view's vmapped step: obs (B, A, n + 4), rewards (B, A), info."""
    jp, p, _ = building_params
    jenv = jma.MultiAgentBuildingEnv()
    env = tma.MultiAgentBuildingEnv(p)
    A = len(env.agents)
    assert env.agent_ids() == jenv.agent_ids(jp) and A == int(
        p.ac_map.sum())
    rng = np.random.default_rng(2)
    epochs = np.array([[0, 4321, p.length_of_weather - 5],
                       [17, 9000, 100]])
    B, T = epochs.shape[1], 13
    acts = rng.uniform(-1, 1, (T, B, A, 1)).astype(np.float32)
    jst, jts = jax.vmap(jenv.reset_at_epoch, in_axes=(None, 0))(
        jp, jnp.asarray(epochs[0], jnp.int32))
    st, ts = env.reset_at_epoch(p, torch.from_numpy(epochs[0]))
    assert ts.obs.shape == (B, A, p.n + 4) and ts.reward.shape == (B, A)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), **BLD)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    for t in range(T):
        jst, jts = vstep(jp, jst, jnp.asarray(acts[t]), jax.random.PRNGKey(0))
        st, ts = env.step(p, st, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), **BLD,
                                   err_msg=f"obs at {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward),
                                   **BLD, err_msg=f"reward at {t}")
        for k in jts.info:
            np.testing.assert_allclose(ts.info[k].numpy(),
                                       np.asarray(jts.info[k]), **BLD,
                                       err_msg=k)
        np.testing.assert_array_equal(ts.terminated.numpy(),
                                      np.asarray(jts.terminated))
        if t == 9:
            assert ts.terminated.all()
            jst, _ = jax.vmap(jenv.reset_at_epoch, in_axes=(None, 0))(
                jp, jnp.asarray(epochs[1], jnp.int32))
            st, _ = env.reset_at_epoch(p, torch.from_numpy(epochs[1]))


def test_ma_building_ppo_lr0(building_params):
    """MA building rides the generic path (the view has no batch_unroll):
    one lr=0 step keeps every ratio at 1."""
    _, p, _ = building_params
    env = tma.MultiAgentBuildingEnv(p)
    cfg = PPOConfig(num_envs=4, rollout_len=6, hidden=16, epochs=1,
                    minibatches=2, lr=0.0)
    init_state, step = make_train_step(env, p, cfg)
    assert step.path == "generic" and step.n_agents == len(env.agents)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    assert carry["obs"].shape == (4, len(env.agents), p.n + 4)
    _, m = step(carry, gen)
    assert abs(float(m["pg_loss"])) < 1e-5 and np.isfinite(
        float(m["vf_loss"]))


# ---------------------------------------------------------------------------
# PPO: per-agent stacked policies, the uniform-obs path, every MA path
# ---------------------------------------------------------------------------

def _stacked_tree(A=4, D=44, act=4, H=32, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), A)
    tree = jax.vmap(lambda k: jppo.init_policy(k, D, act, H))(keys)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    rng = np.random.default_rng(seed)
    for k in ("trunk1", "trunk2", "mu", "value"):
        tree[k]["b"] = rng.normal(0, 0.1, tree[k]["b"].shape).astype(
            np.float32)
    tree["log_std"] = rng.normal(-0.5, 0.2, (A, act)).astype(np.float32)
    return tree


def test_per_agent_apply_logp_entropy_match_jax():
    """per_agent_apply, the masked Gaussian log-prob and the masked
    entropy / n_agents against the JAX package's functions, on weights
    converted by from_jax (which round-trips the stacked tree)."""
    tree = _stacked_tree()
    policy = from_jax(tree, device="cpu")
    assert isinstance(policy, tppo.StackedActorCritic)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(to_jax(policy))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    obs = rng.normal(0, 1, (5, 7, 4, 44)).astype(np.float32)
    u = rng.normal(0, 1, (5, 7, 4, 4)).astype(np.float32)
    mask_np = tma.MultiAgentCogenEnv().action_pad_mask()
    jmu, jls, jv = jppo.per_agent_apply(jax.tree.map(jnp.asarray, tree),
                                        jnp.asarray(obs))
    tmu, tls, tv = per_agent_apply(policy, torch.from_numpy(obs))
    for t, j in ((tmu, jmu), (tls, jls), (tv, jv)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)
    mask = jnp.asarray(mask_np, jnp.float32)
    jl = jppo._gauss_logp(jmu, jls, jnp.asarray(u), mask)
    tmask = torch.from_numpy(mask_np.astype(np.float32))
    tl = tppo._gauss_logp(tmu, tls, torch.from_numpy(u), tmask)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    je = jnp.sum(mask * (jls + 0.5 * jnp.log(2 * jnp.pi * jnp.e))) / 4
    batch = {"obs": torch.from_numpy(obs[0]), "u": torch.from_numpy(u[0]),
             "logp": tl[0].detach(), "adv": torch.ones(7, 4),
             "ret": torch.zeros(7, 4)}
    _, m = tppo.loss_fn(policy, batch, PPOConfig(),
                        tppo._apply_stacked_f32, 0, tmask)
    np.testing.assert_allclose(float(m["entropy"]), float(je), rtol=1e-5,
                               atol=1e-5)


def test_uma_loss_matches_jax_formula():
    """The uniform-obs loss (the shared trunk once per row, u and logp
    (rows, n_agents), the advantage broadcast over the agents) against the
    JAX package's formula (sustaingym_tpu/parallel/ppo.py:554-587) on one
    fixed batch."""
    rng = np.random.default_rng(4)
    D, A, H, M = 146, 54, 32, 48
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jppo.init_policy(jax.random.PRNGKey(3), D, 1, H))
    tree["log_std"] = np.array([-0.3], np.float32)
    obs = rng.normal(0, 1, (M, D)).astype(np.float32)
    u = rng.normal(0, 1, (M, A)).astype(np.float32)
    old = rng.normal(-1, 0.3, (M, A)).astype(np.float32)
    adv = rng.normal(0, 2, M).astype(np.float32)
    ret = rng.normal(0, 1, M).astype(np.float32)
    cfg = PPOConfig()
    mu, ls, value = jppo.policy_apply(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(obs))
    lsb = ls[None, :]
    logp = -0.5 * ((jnp.asarray(u) - mu) ** 2 * jnp.exp(-2 * lsb)
                   + 2 * lsb + jnp.log(2 * jnp.pi))
    a = jnp.asarray(adv)
    a = ((a - a.mean()) / (a.std() + 1e-8))[:, None]
    ratio = jnp.exp(logp - jnp.asarray(old))
    pg = -jnp.minimum(ratio * a, jnp.clip(ratio, 0.8, 1.2) * a).mean()
    vf = 0.5 * jnp.mean((value - jnp.asarray(ret)) ** 2)
    ent = jnp.sum(ls + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
    batch = {k: torch.from_numpy(v) for k, v in
             dict(obs=obs, u=u, logp=old, adv=adv, ret=ret).items()}
    loss, m = tppo.loss_fn(from_jax(tree, device="cpu"), batch, cfg,
                           tppo._apply_f32, 0, None, True)
    for k, want in (("pg_loss", pg), ("vf_loss", vf), ("entropy", ent)):
        np.testing.assert_allclose(float(m[k].detach()), float(want),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()),
                               float(pg + cfg.vf_coef * vf), rtol=1e-5)


def test_uma_path_matches_agent_axis_path():
    """The uniform-obs path (trunk once per env, per-agent draws around
    the shared mu) takes the same lr=0 step as the agent-axis path on the
    same view with the fast path refused (1 epoch, 1 minibatch, the same
    generator seed: the same draws, so the same rollout)."""
    cfg = PPOConfig(num_envs=2, hidden=32, epochs=1, minibatches=1, lr=0.0,
                    obs_bf16=True)
    env, p = make("evcharging-multiagent", project_action=False,
                  device="cpu")
    init_state, fast = make_train_step(env, p, cfg)
    assert fast.uma and fast.path == "episodic"
    slow_env = tma.MultiAgentEVChargingEnv()
    slow_env.uniform_agent_obs = lambda params: False
    init2, slow = make_train_step(slow_env, p, cfg)
    assert not slow.uma and slow.path == "episodic"
    gen = torch.Generator().manual_seed(0)
    _, m_fast = fast(init_state(gen), gen)
    gen = torch.Generator().manual_seed(0)
    _, m_slow = slow(init2(gen), gen)
    for k in m_slow:
        np.testing.assert_allclose(float(m_fast[k]), float(m_slow[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    assert abs(float(m_fast["pg_loss"])) < 1e-5


def _ma_trainer(case, **cfg_kw):
    name, kw, cfg = {
        "uma": ("evcharging-multiagent", dict(project_action=False),
                dict(num_envs=2, obs_bf16=True)),
        "delay2": ("evcharging-multiagent",
                   dict(project_action=False, periods_delay=2),
                   dict(num_envs=2, obs_bf16=True)),
        "discrete": ("evcharging-multiagent",
                     dict(project_action=False, discrete_bins=5),
                     dict(num_envs=4, rollout_len=6)),
        "cogen": ("cogen-multiagent", {},
                  dict(num_envs=8, rollout_len=6, reward_scale=1e-4)),
    }[case]
    env, p = make(name, device="cpu", **kw)
    cfg = PPOConfig(**{**dict(hidden=16, epochs=1, minibatches=2), **cfg,
                       **cfg_kw})
    return env, p, cfg


@pytest.mark.parametrize("case,path", [
    ("uma", "episodic"), ("delay2", "episodic"), ("discrete", "generic"),
    ("cogen", "generic")])
def test_ma_paths_lr0_exact_ratio(case, path):
    """lr=0 on each multi-agent path (MA building: test_ma_building_ppo_
    lr0): every ratio is exactly 1, the weights do not move; the rows
    and heads are the JAX package's."""
    env, p, cfg = _ma_trainer(case, lr=0.0)
    init_state, step = make_train_step(env, p, cfg)
    assert step.path == path
    assert step.uma == (case == "uma")
    assert step.per_agent == (case == "cogen")
    gen = torch.Generator().manual_seed(1)
    carry = init_state(gen)
    w0 = [w.detach().clone() for w in carry["policy"].parameters()]
    out = step.rollout(carry["policy"], gen, carry)
    flat = step.score(carry["policy"], out)
    A = step.n_agents
    rows = {"uma": 288 * 2, "delay2": 288 * 2 * A, "discrete": 6 * 4 * A,
            "cogen": 6 * 8}[case]
    assert flat["logp"].shape[0] == rows
    if case == "uma":
        assert flat["u"].shape == flat["logp"].shape == (rows, A)
    if case == "cogen":
        assert flat["obs"].shape[:2] == flat["adv"].shape == (rows, 4)
    if case == "discrete":
        assert carry["policy"].mu.weight.shape[0] == 5
        assert flat["u"].dtype == torch.long
    _, m = step(carry, gen)
    assert abs(float(m["pg_loss"])) < 1e-5, m
    assert np.isfinite(float(m["vf_loss"]))
    for a, b in zip(carry["policy"].parameters(), w0):
        assert torch.equal(a, b)


def test_every_cogen_agent_trains():
    """One step of the per-agent stacked policies updates every agent's
    own weights; ST's padded log_std slot gets no gradient and stays at
    -0.5 (tests/test_ppo.py::test_ppo_multiagent_cogen_per_agent_
    policies)."""
    env, p, cfg = _ma_trainer("cogen", lr=1e-3)
    init_state, step = make_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(2)
    carry = init_state(gen)
    pol = carry["policy"]
    assert pol.trunk1.weight.shape[0] == 4 and pol.mu.weight.shape[-1] == 4
    before = pol.mu.weight.detach().clone()
    _, m = step(carry, gen)
    for a in range(4):
        assert not torch.allclose(before[a], pol.mu.weight[a]), a
    assert float(pol.log_std[3, 3]) == -0.5
    assert float(pol.log_std[0, 0]) != -0.5
    assert np.isfinite(float(m["mean_reward"]))


def test_ma_gates_and_minibatch_errors():
    """Per-agent policies refuse a discrete padded space; too few rows
    raise with the JAX package's wording; the uniform-obs path is taken
    only at the episode length."""
    env, p, cfg = _ma_trainer("discrete", minibatches=10_000)
    init_state, step = make_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError,
                       match=r"rollout_len\*num_envs\[\*n_agents\]"):
        step(init_state(gen), gen)

    class DiscreteCogen(tma.MultiAgentCogenEnv):
        def padded_action_space(self, params):
            from sustaingym_tpu_torch.core import MultiDiscrete
            return MultiDiscrete(np.full((4, 4), 3))

    _, cp, ccfg = _ma_trainer("cogen")
    with pytest.raises(ValueError, match="per-agent policies"):
        make_train_step(DiscreteCogen(), cp, ccfg)
    env, p, cfg = _ma_trainer("uma", rollout_len=64)
    _, step = make_train_step(env, p, cfg)
    assert step.path == "generic" and not step.uma


@pytest.mark.parametrize("name", ["cogen-multiagent",
                                  "evcharging-multiagent"])
def test_train_cli_multiagent(name, tmp_path):
    """The CLI on the CPU: MA cogen (reward scale 1e-4 by default) and
    MA-EV with --eval-every 1 (the evaluation sums the agents' rewards)."""
    from sustaingym_tpu_torch import train
    args = ["--env", name, "--device", "cpu", "--num-envs", "4",
            "--rollout-len", "8", "--hidden", "16", "--minibatches", "2",
            "--epochs", "1", "--iterations", "1", "--log-dir", str(tmp_path)]
    if name == "evcharging-multiagent":
        args += ["--eval-every", "1", "--eval-episodes", "2",
                 "--env-kwargs", '{"project_action": false}']
    train.main(args)
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert len(rows) == 2 and "pg_loss" in rows[0]
    if name == "evcharging-multiagent":
        ev = (tmp_path / "eval_results.csv").read_text().splitlines()
        assert len(ev) == 2 and np.isfinite(float(ev[1].split(",")[1]))
