"""PyTorch port of CogenEnv (sustaingym_tpu_torch.envs.cogen), its rollout
paths, the plain version of the cogen episode kernel and the episodic PPO
path, against the JAX package on the same packed data, days, reset actions
and prescribed actions (made with numpy from a seed).

Tolerances: plant outputs, rewards and costs rtol 2e-5 / atol 0.2 (the
JAX package's own bound for its kernel against its step loop: relus at
active constraint boundaries times the 1000 penalties amplify float
reassociation); observations rtol 1e-6 / atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.envs import cogen as jcogen
from sustaingym_tpu.envs.cogen import plant as jplant
from sustaingym_tpu.core import flatten as jflatten
from sustaingym_tpu.parallel import ppo as jppo
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import (autoreset_step, batch_rollout,
                                       episode_return, flatdim, flatten,
                                       random_policy, replace, tree_map,
                                       tree_select, tree_stack)
from sustaingym_tpu_torch.envs import cogen as tcogen
from sustaingym_tpu_torch.envs.cogen import env as tenv_mod
from sustaingym_tpu_torch.envs.cogen import plant as tplant
from sustaingym_tpu_torch.ops.cuda import cogen_rollout as KB
from sustaingym_tpu_torch.ops.cuda import exog_gather as KA
from sustaingym_tpu_torch.parallel import (PPOConfig, from_jax,
                                           make_train_step, policy_apply)
from sustaingym_tpu_torch.parallel import ppo as tppo

SIM = dict(rtol=2e-5, atol=0.2)
OBS = dict(rtol=1e-6, atol=1e-5)
LOW = tenv_mod.ACTION_LOW.astype(np.float32)
HIGH = tenv_mod.ACTION_HIGH.astype(np.float32)


@pytest.fixture(scope="module")
def both():
    jenv, jp = jcogen.make_env(forecast_horizon=3, forecast_noise_std=0.0)
    tenv, tp = tcogen.make_env(forecast_horizon=3, forecast_noise_std=0.0,
                               device="cpu")
    return (jenv, jp), (tenv, tp)


def _actions(rng, *shape):
    """Uniform actions over the box, as tests/test_cogen.py draws them."""
    u = rng.uniform(0, 1, shape + (15,)).astype(np.float32)
    return (LOW + u * (HIGH - LOW)).astype(np.float32)


def test_make_params_matches_jax(both):
    (_, jp), (_, tp) = both
    np.testing.assert_array_equal(tp.ambients.numpy(), np.asarray(jp.ambients))
    assert (tp.n_days, tp.timesteps_per_day, tp.forecast_horizon) == (
        jp.n_days, jp.timesteps_per_day, jp.forecast_horizon)
    for name in ("ramp_penalty", "supply_imbalance_penalty",
                 "constraint_violation_penalty", "forecast_noise_std"):
        assert getattr(tp, name) == float(getattr(jp, name))
    with pytest.raises(FileNotFoundError, match="raw ETL inputs"):
        tcogen.make_params(renewables_magnitude=50.0, device="cpu")


def test_plant_model_and_step_core_match_jax(both):
    (jenv, jp), (_, tp) = both
    rng = np.random.default_rng(0)
    B = 512
    amb = np.asarray(jp.ambients)[rng.integers(0, jp.n_days, B),
                                  rng.integers(0, 96, B)]
    act, prev = _actions(rng, B), _actions(rng, B)
    x = np.asarray(jax.vmap(jcogen.env.pack_model_input)(
        jnp.asarray(amb), jnp.asarray(act)))
    tx = tenv_mod.pack_model_input(torch.from_numpy(amb),
                                   torch.from_numpy(act))
    np.testing.assert_array_equal(tx.numpy(), x)
    np.testing.assert_allclose(
        tplant.plant_model(tx).numpy(),
        np.asarray(jplant.plant_model_batched(jnp.asarray(x))), **SIM)

    jr, ji = jax.vmap(jenv._step_core, in_axes=(None, 0, 0, 0))(
        jp, jnp.asarray(prev), jnp.asarray(act), jnp.asarray(amb))
    tr, ti = tcogen.step_core(tp, torch.from_numpy(prev),
                              torch.from_numpy(act), torch.from_numpy(amb))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **SIM)
    assert set(ti) == set(ji)
    for k in ji:
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), **SIM,
                                   err_msg=k)


def _jax_reset(jenv, jp, days, prev):
    """The JAX package's reset at ``days`` with the previous action set
    through state.replace (noiseless forecasts: the keys do not matter)."""
    k = jax.random.PRNGKey(0)
    st, _ = jax.vmap(jenv.reset_at_day, in_axes=(None, 0, None, None))(
        jp, jnp.asarray(days, jnp.int32), k, k)
    st = st.replace(prev_action=jnp.asarray(prev))
    obs = jax.vmap(jenv._obs, in_axes=(None, 0, None, 0))(jp, st, k, st.slab)
    return st, obs


def _jax_step_loop(jenv, jp, days, prev, actions):
    """The JAX vmapped env.step loop over prescribed actions, with the
    autoreset splice at the 96-step boundary: days (2, B), prev (2, B, 15),
    actions (T, B, 15). Returns stacked (reward, terminated, info, obs)."""
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    st, _ = _jax_reset(jenv, jp, days[0], prev[0])
    out = []
    for t in range(actions.shape[0]):
        st, ts = vstep(jp, st, jnp.asarray(actions[t]), jax.random.PRNGKey(1))
        obs = ts.obs
        if t == 95:
            st, obs = _jax_reset(jenv, jp, days[1], prev[1])
        out.append((ts.reward, ts.terminated, ts.info, obs))
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *out)


@pytest.mark.parametrize("path", ["batch_unroll", "fused_rollout"])
def test_episode_paths_match_jax_step_loop(both, path):
    """batch_unroll and fused_rollout's plain path (CPU: the plain
    versions of both kernels) across an episode boundary (98 steps) on
    prescribed actions from the same reset state, against the JAX vmapped
    step loop."""
    (jenv, jp), (tenv, tp) = both
    rng = np.random.default_rng(7)
    B, T = 8, 98
    days = rng.integers(0, tp.n_days - 1, (2, B))
    prev = _actions(rng, 2, B)
    actions = _actions(rng, T, B)
    jr, jterm, jinfo, jobs = _jax_step_loop(jenv, jp, days, prev, actions)

    counts = (KA.episode_slice_gather.launches, KB.cogen_segment.launches)
    tacts = torch.from_numpy(actions)
    if path == "batch_unroll":
        step = iter(range(T))
        out = tenv.batch_unroll(tp, lambda _, obs, g: tacts[next(step)], None,
                                B, T, days=days, prev_action=prev)
    else:
        out = tenv.fused_rollout(tp, B, T, actions=tacts, days=days,
                                 prev_action=prev)
    assert (KA.episode_slice_gather.launches,
            KB.cogen_segment.launches) == counts   # CPU: plain versions
    np.testing.assert_allclose(out.reward.numpy(), jr, **SIM)
    np.testing.assert_array_equal(out.terminated.numpy(), jterm)
    for k in jinfo:
        np.testing.assert_allclose(out.info[k].numpy(), jinfo[k], **SIM,
                                   err_msg=k)
    for k in jobs:
        np.testing.assert_allclose(out.obs[k].numpy(), jobs[k], **OBS,
                                   err_msg=k)


def test_cogen_segment_ref_rows_and_draws(both):
    """The plain kernel version's (30, T, B) rows on prescribed actions are
    step_core's fields; in RNG mode its draws follow sample_action's
    distribution (Box components in bounds, 0/1 switches, bays 1..12)."""
    (_, _), (_, tp) = both
    rng = np.random.default_rng(3)
    B, T = 16, 5
    days = torch.from_numpy(rng.integers(0, tp.n_days, B))
    prev = torch.from_numpy(_actions(rng, B))
    acts = torch.from_numpy(_actions(rng, T, B))
    out = KB.cogen_segment(tp, days, prev, T, actions=acts)
    action, reward, info = KB.segment_fields(out)
    assert torch.equal(action, acts)
    r, i = tcogen.step_core(tp, acts[0], acts[1], tp.ambients[days, 1])
    assert torch.equal(reward[1], r)
    for k in i:
        assert torch.equal(info[k][1], i[k]), k
    a, _, _ = KB.segment_fields(KB.cogen_segment(tp, days, prev, T, seed=5))
    a = a.reshape(-1, 15)
    box = [i for i in range(15) if i not in tenv_mod.BINARY_IDX + (14,)]
    assert bool(((a[:, box] >= torch.from_numpy(LOW[box]))
                 & (a[:, box] <= torch.from_numpy(HIGH[box]))).all())
    assert set(a[:, list(tenv_mod.BINARY_IDX)].unique().tolist()) <= {0., 1.}
    assert set(a[:, 14].unique().tolist()) <= set(range(1, 13))


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_generic_rollout_matches_batch_unroll(noise):
    """The lockstep batch_unroll and the generic env.step loop with
    autoreset draw from the generator in the same order, so with the same
    seed they give the same trajectory across the episode boundary (with
    and without forecast noise)."""
    env, p = make("cogen", forecast_noise_std=noise, device="cpu")
    B, T = 6, 98

    def roll(fast):
        g = torch.Generator().manual_seed(11)
        return batch_rollout(env, p, random_policy(env, p, B), None, g, B, T,
                             fast=fast)

    fast, slow = roll(True), roll(False)
    tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
             fast, slow)
    assert fast.terminated[95].all() and not fast.terminated[:95].any()
    assert torch.equal(episode_return(fast), fast.reward.sum(0))


def test_autoreset_resets_only_done_envs():
    env, p = make("cogen", device="cpu")
    g = torch.Generator().manual_seed(2)
    st, _ = env.reset(p, g, 4)
    # envs 1 and 3 at the last step of their day
    t = torch.tensor([0, 95, 10, 95])
    st = replace(st, t=t, slab=torch.stack(
        [torch.roll(s, -int(k), -1) for s, k in zip(st.slab, t)]))
    a = env.sample_action(p, g, 4)
    new, ts = autoreset_step(env)(p, st, a, g)
    assert ts.terminated.tolist() == [False, True, False, True]
    assert new.t.tolist() == [1, 0, 11, 0]
    assert torch.equal(new.prev_action[[0, 2]], a[[0, 2]])
    assert not torch.equal(new.prev_action[[1, 3]], a[[1, 3]])
    assert torch.equal(ts.obs["Prev_Action"][[1, 3]], new.prev_action[[1, 3]])
    assert ts.obs["Time"][[1, 3]].eq(0).all()


def test_tree_select_and_stack():
    pred = torch.tensor([True, False, True])
    a = {"x": torch.ones(3, 2), "s": 1}
    b = {"x": torch.zeros(3, 2), "s": 2}
    sel = tree_select(pred, a, b)
    assert sel["s"] == 1
    assert sel["x"].tolist() == [[1, 1], [0, 0], [1, 1]]
    st = tree_stack([a, b])
    assert st["x"].shape == (2, 3, 2) and st["s"] == 1


def test_reset_days_and_sampled_actions():
    """reset keeps the JAX package's day range (never the last day) and
    sample_action's discrete components."""
    env, p = make("cogen", device="cpu")
    st, ts = env.reset(p, torch.Generator().manual_seed(0), 20000)
    assert int(st.day.max()) == p.n_days - 2 and int(st.day.min()) == 0
    a = st.prev_action
    assert set(a[:, 14].unique().tolist()) == set(range(1, 13))
    assert set(a[:, list(tenv_mod.BINARY_IDX)].unique().tolist()) == {0., 1.}
    assert abs(float(a[:, 1].mean()) - 0.5) < 0.02


def test_observation_flattening_matches_jax(both):
    """The flat obs is 1 + 15 + 7 x 4 = 44 wide, in the JAX package's
    DictSpace order."""
    (jenv, jp), (tenv, tp) = both
    assert flatdim(tenv.observation_space(tp)) == 44
    assert list(tenv.observation_space(tp).spaces) == list(
        jenv.observation_space(jp).spaces)
    rng = np.random.default_rng(4)
    days, prev = rng.integers(0, tp.n_days - 1, 3), _actions(rng, 3)
    _, jobs = _jax_reset(jenv, jp, days, prev)
    _, ts = tenv.reset_at_day(tp, torch.from_numpy(days), prev_action=prev)
    jflat = np.asarray(jax.vmap(lambda o: jflatten(
        jenv.observation_space(jp), o))(jobs))
    np.testing.assert_allclose(
        flatten(tenv.observation_space(tp), ts.obs, 1).numpy(), jflat, **OBS)


def test_fused_rollout_rng_and_noisy_handover():
    """RNG-mode fused rollouts are reproducible from the generator; noisy
    forecasts hand over to batch_unroll with a uniform random policy."""
    env, p = make("cogen", device="cpu")
    r1 = env.fused_rollout(p, 8, 20, generator=torch.Generator().manual_seed(3))
    r2 = env.fused_rollout(p, 8, 20, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(r1.reward.numpy(), r2.reward.numpy())
    assert np.isfinite(r1.reward.numpy()).all()
    env, p = make("cogen", forecast_noise_std=0.5, device="cpu")
    fused = env.fused_rollout(p, 8, 20,
                              generator=torch.Generator().manual_seed(4))
    unroll = env.batch_unroll(p, random_policy(env, p, 8), None, 8, 20,
                              torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(fused.obs["TAMB"].numpy(),
                                  unroll.obs["TAMB"].numpy())
    with pytest.raises(ValueError):
        env.fused_rollout(p, 8, 20, actions=torch.zeros((20, 8, 15)))


def test_from_jax_cogen_policy_matches_jax():
    tree = jppo.init_policy(jax.random.PRNGKey(3), 44, 15, 64,
                            dtype=jnp.float32)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    rng = np.random.default_rng(5)
    for k in ("trunk1", "trunk2", "mu", "value"):
        tree[k]["b"] = rng.normal(0, 0.1, tree[k]["b"].shape).astype(
            np.float32)
    obs = rng.normal(0, 1, (32, 44)).astype(np.float32)
    jmu, jls, jv = jppo.policy_apply(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(obs))
    tmu, tls, tv = policy_apply(from_jax(tree, device="cpu"),
                                torch.from_numpy(obs))
    for t, j in ((tmu, jmu), (tls, jls), (tv, jv)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("obs_bf16", [False, True])
def test_episodic_ppo_lr0_exact_ratio(obs_bf16):
    """The episodic path on CogenEnv (batch_unroll, f32 policy, tanh squash
    to the Box): with lr=0 every ratio is 1, so pg_loss vanishes and the
    weights stay put; whole 96-step episodes end on their last step."""
    env, p = make("cogen", device="cpu")
    cfg = PPOConfig(num_envs=32, hidden=32, minibatches=4, epochs=1, lr=0.0,
                    reward_scale=1e-4, obs_bf16=obs_bf16)
    init_state, train_step = make_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    w0 = carry["policy"].trunk1.weight.detach().clone()
    out = train_step.rollout(carry["policy"], gen)
    assert out["obs"].shape == (96, 32, 44) and out["u"].shape == (96, 32, 15)
    assert out["obs"].dtype == (torch.bfloat16 if obs_bf16 else torch.float32)
    # a minibatch re-scored as the update scores it: every ratio exactly 1
    flat = train_step.score(carry["policy"], out)
    idx = torch.randperm(flat["logp"].shape[0], generator=gen)[:768]
    mu, log_std, _ = tppo._apply_f32(carry["policy"], flat["obs"][idx])
    assert torch.equal(tppo._gauss_logp(mu, log_std, flat["u"][idx]),
                       flat["logp"][idx])
    carry, metrics = train_step(carry, gen)
    m = {k: float(v) for k, v in metrics.items()}
    assert abs(m["pg_loss"]) < 1e-5, m
    assert np.isfinite(m["vf_loss"]) and m["vf_loss"] > 0
    assert m["episode_done_frac"] == pytest.approx(1.0 / 96)
    assert torch.equal(carry["policy"].trunk1.weight, w0)


def test_train_cli_cogen_cpu(tmp_path):
    from sustaingym_tpu_torch import train
    train.main(["--env", "cogen", "--device", "cpu", "--num-envs", "8",
                "--hidden", "16", "--minibatches", "2", "--epochs", "1",
                "--iterations", "1", "--log-dir", str(tmp_path)])
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert len(rows) == 2 and "pg_loss" in rows[0]


def _present_batch_unroll(env, p, policy, batch, num_steps, generator):
    """CogenEnv.batch_unroll as one loop over every step, as it was before
    its step loop became the part a CUDA graph captures."""
    from sustaingym_tpu_torch.core import TimeStep, replace, tree_stack
    L, h = p.timesteps_per_day, p.forecast_horizon
    rows = L + h + 1
    flat = p.ambients.reshape(-1, p.ambients.shape[-1])
    day, prev, obs = env._episode_start(p, 0, batch, generator, None, None)
    traj = []
    for ep, t0 in enumerate(range(0, num_steps, L)):
        seg = min(L, num_steps - t0)
        block = KA.episode_slice_gather(flat, day * rows, rows).transpose(0, 1)
        for t in range(seg):
            actions = policy(None, obs, generator)
            reward, info = tenv_mod.step_core(p, prev, actions, block[t])
            t_next = torch.full((batch,), t + 1, dtype=torch.long)
            window = env._noisy(p, block[t + 1:t + h + 2].transpose(0, 1),
                                generator)
            obs = env._obs(p, t_next, actions, window)
            traj.append(TimeStep(
                obs=obs, reward=reward, terminated=t_next >= L,
                truncated=torch.zeros_like(t_next, dtype=torch.bool),
                info=info))
            prev = actions
        if seg == L:
            day, prev, obs = env._episode_start(p, ep + 1, batch, generator,
                                                None, None)
            traj[-1] = replace(traj[-1], obs=obs)
    return tree_stack(traj)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_split_batch_unroll_matches_the_present_loop(noise):
    """batch_unroll split into an eager episode start and a step loop
    (_episode_steps, which a CUDA graph captures on the card), called
    directly and through a CPU Graphs, against the loop it replaces: bit
    for bit across the episode boundary."""
    from sustaingym_tpu_torch.core.graph import Graphs
    env, p = make("cogen", forecast_noise_std=noise, device="cpu")
    B, T = 4, 98
    policy = random_policy(env, p, B)
    want = _present_batch_unroll(env, p, policy, B, T,
                                 torch.Generator().manual_seed(5))
    for graphs in (None, Graphs("cpu")):
        got = env.batch_unroll(p, policy, None, B, T,
                               torch.Generator().manual_seed(5),
                               graphs=graphs)
        tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(),
                                                            y.numpy()),
                 got, want)
