"""PyTorch port of BuildingEnv (sustaingym_tpu_torch.envs.building), its
rollout paths, the plain versions of the two building episode kernels and
PPO on building, against the JAX package.

Both packages compile the same files: the zone table and the weather year
that ``envs/building/synthetic.py`` writes (6 zones, a seeded year
in Tucson's range), through their own ``generate_building_params``. Inputs
are made with numpy from a seed. Tolerances, each with its reason:
- the host compiler's arrays and ``make_params``' tensors: bit-equal (the
  same float64 NumPy code, the same float32 rounding);
- env steps: rtol 1e-6 / atol 1e-5 (the RC product is a matmul in both
  packages, summed in other orders);
- the port's lockstep path against its generic step loop: rewards and
  info bit-equal, obs rtol 3e-7 (the JAX package's own bound,
  tests/test_building.py:138-165);
- the episode kernels' plain versions against the Pallas kernels
  (interpret mode): the JAX package's bounds for its kernels,
  tests/test_building.py:223-230 and tests/test_ops_pallas.py:461-478.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sustaingym_tpu.core import flatten as jflatten
from sustaingym_tpu.envs import building as jb
from sustaingym_tpu.parallel import ppo as jppo
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import (MultiDiscrete, batch_rollout, flatdim,
                                       flatten, random_policy, replace)
from sustaingym_tpu_torch.envs import building as tb
from sustaingym_tpu_torch.envs.building import synthetic
from sustaingym_tpu_torch.ops.cuda import building_rollout as K5
from sustaingym_tpu_torch.ops.cuda import exog_gather as KA
from sustaingym_tpu_torch.ops.cuda.ev_rollout import pack_policy_weights
from sustaingym_tpu_torch.parallel import PPOConfig, from_jax, make_train_step

STEP_TOL = dict(rtol=1e-6, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-4)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("building_tables")
    htm, epw = synthetic.write_building_tables(str(root))
    return str(root), htm, epw


def _dicts(tables, **kw):
    root, htm, epw = tables
    jd = jb.generate_building_params(htm, epw, "Tucson",
                                     u_wall=jb.BUILDINGS["OfficeSmall"][1],
                                     root=root, **kw)
    td = tb.generate_building_params(htm, epw, "Tucson",
                                     u_wall=tb.BUILDINGS["OfficeSmall"][1],
                                     root=root, **kw)
    return jd, td


@pytest.fixture(scope="module")
def dicts(tables):
    return _dicts(tables)


def _params(dicts, **changes):
    jd, td = dicts
    return (jb.make_params({**jd, **changes}, dtype=jnp.float32),
            tb.make_params({**td, **changes}, device="cpu"))


@pytest.mark.parametrize("stochastic", [False, True])
def test_generate_building_params_bit_equal(tables, dicts, stochastic):
    """Every array of the two compilers' dicts is bit-equal; with
    stochastic ambients both draw the same numbers from default_rng(0). The
    compiled 6-zone operator is finite and stable."""
    kw = (dict(stochastic_summer_percentage=0.7, stochastic_seed=0)
          if stochastic else {})
    jd, td = _dicts(tables, **kw) if stochastic else dicts
    assert jd.keys() == td.keys()
    for k, jv in jd.items():
        tv = td[k]
        if k == "zones":
            assert [tuple(z) for z in tv] == [tuple(z) for z in jv]
        elif isinstance(jv, np.ndarray):
            assert tv.dtype == jv.dtype
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            assert tv == jv, k
    if stochastic:
        assert not np.allclose(td["out_temp"][:100],
                               dicts[1]["out_temp"][:100])
        return
    assert td["n"] == 6 and td["out_temp"].shape == (105108,)
    tp = tb.make_params(td, device="cpu")
    a_d = tp.A_d.double().numpy()
    assert tp.BD_d.shape == (6, 10) and np.isfinite(a_d).all()
    assert np.isfinite(tp.BD_d.numpy()).all()
    assert np.abs(np.linalg.eigvals(a_d)).max() < 1.0


def test_make_params_matches_jax(dicts):
    jp, tp = _params(dicts)
    for name in ("A_d", "BD_d", "exog", "target", "ac_map", "q_rate",
                 "error_rate", "out_temp", "ground_temp", "ghi",
                 "metabolism"):
        tv, jv = getattr(tp, name), np.asarray(getattr(jp, name))
        assert tv.dtype == torch.float32 and tv.shape == jv.shape, name
        np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)
    assert tp.exog.shape == (105108 + 288, 4)
    for name in ("n", "episode_len", "length_of_weather", "reward_pnorm",
                 "max_power", "time_resolution", "temp_min", "temp_max",
                 "is_continuous_action", "data_driven"):
        assert getattr(tp, name) == getattr(jp, name), name
    jenv, tenv = jb.BuildingEnv(), tb.BuildingEnv()
    for name in ("observation_space", "action_space"):
        js, ts = getattr(jenv, name)(jp), getattr(tenv, name)(tp)
        assert js.shape == ts.shape
        np.testing.assert_array_equal(ts.low, js.low)
        np.testing.assert_array_equal(ts.high, js.high)
    assert tenv.epoch_from_seed(tp, 123) == jenv.epoch_from_seed(jp, 123)


def test_multidiscrete_matches_jax(dicts):
    """The discrete building's action space: same nvec, flatten as one
    one-hot per dimension, draws floor(u * nvec) inside the space."""
    jp, tp = _params(dicts, is_continuous_action=False)
    js = jb.BuildingEnv().action_space(jp)
    ts = tb.BuildingEnv().action_space(tp)
    assert isinstance(ts, MultiDiscrete)
    np.testing.assert_array_equal(ts.nvec, js.nvec)
    assert flatdim(ts) == 6 * 200
    a = np.random.default_rng(1).integers(0, 200, (3, 6))
    flat = flatten(ts, torch.from_numpy(a), batch_dims=1)
    for b in range(3):
        np.testing.assert_array_equal(flat[b].numpy(),
                                      np.asarray(jflatten(js, a[b])))
    s = ts.sample_batch(torch.Generator().manual_seed(0), 4096)
    assert s.shape == (4096, 6) and s.dtype == torch.long
    assert int(s.min()) == 0 and int(s.max()) == 199


# a seeded non-negative data-driven operator: each input column scaled by
# its typical size [avg^2, avg, meta^2, meta, ground, out, a(n), ghi]
_DD_SCALE = np.array([500.0, 25.0, 15000.0, 120.0, 20.0, 25.0] + [1.0] * 6
                     + [1.0])


@pytest.mark.parametrize("mode", ["continuous", "discrete", "data_driven"])
def test_step_matches_jax(dicts, mode):
    """reset_at_epoch and 30 batched steps against the JAX vmapped env,
    from epochs that include T - 2 and T - 15 (the weather wraps to epoch
    0 after one and fourteen steps)."""
    changes = {"is_continuous_action": False} if mode == "discrete" else {}
    jp, tp = _params(dicts, **changes)
    n, Tw = tp.n, tp.length_of_weather
    rng = np.random.default_rng(0)
    if mode == "data_driven":
        bd = rng.uniform(0.0, 0.02, (n, n + 7)) / _DD_SCALE
        jp = jp.replace(BD_d=jnp.asarray(bd, jnp.float32), data_driven=True)
        tp = replace(tp, BD_d=torch.as_tensor(bd, dtype=torch.float32),
                     data_driven=True)
    jenv, tenv = jb.BuildingEnv(), tb.BuildingEnv()
    epochs = np.array([0, 4321, Tw - 2, Tw - 15])
    B, T = len(epochs), 30
    if mode == "discrete":
        acts = rng.integers(0, 200, (T, B, n)).astype(np.int32)
    else:
        acts = rng.uniform(-1, 1, (T, B, n)).astype(np.float32)
    jst, jts = jax.vmap(jenv.reset_at_epoch, in_axes=(None, 0))(
        jp, jnp.asarray(epochs, jnp.int32))
    tst, tts = tenv.reset_at_epoch(tp, torch.from_numpy(epochs))
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs),
                               **STEP_TOL)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    for t in range(T):
        jst, jts = vstep(jp, jst, jnp.asarray(acts[t]), jax.random.PRNGKey(0))
        tst, tts = tenv.step(tp, tst, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs),
                                   **STEP_TOL, err_msg=f"obs at {t}")
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                                   **STEP_TOL, err_msg=f"reward at {t}")
        for k in jts.info:
            np.testing.assert_allclose(tts.info[k].numpy(),
                                       np.asarray(jts.info[k]), **STEP_TOL,
                                       err_msg=f"{k} at {t}")
        np.testing.assert_array_equal(tst.epoch.numpy(), np.asarray(jst.epoch))
        assert not tts.terminated.any()
    assert tst.epoch.tolist() == [30, 4351, 28, 15]


@pytest.mark.parametrize("steps", [7, 25])
def test_batch_unroll_matches_generic(dicts, steps):
    """The lockstep batch_unroll (one exog slice gather per episode) and
    the generic step loop with autoreset draw from the generator in the
    same order: a partial episode, and across two boundaries."""
    _, tp = _params(dicts, episode_len=10)
    env, B = tb.BuildingEnv(), 8

    def roll(fast):
        g = torch.Generator().manual_seed(3)
        return batch_rollout(env, tp, random_policy(env, tp, B), None, g, B,
                             steps, fast=fast)

    launches = KA.episode_slice_gather.launches
    fast, slow = roll(True), roll(False)
    assert KA.episode_slice_gather.launches == launches   # CPU: plain
    for name in ("reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(fast, name).numpy(),
                                      getattr(slow, name).numpy(),
                                      err_msg=name)
    np.testing.assert_allclose(fast.obs.numpy(), slow.obs.numpy(),
                               rtol=3e-7, atol=1e-7)
    for k in slow.info:
        np.testing.assert_array_equal(fast.info[k].numpy(),
                                      slow.info[k].numpy(), err_msg=k)
    assert fast.obs.shape == (steps, B, tp.n + 4)
    assert fast.terminated.sum(1).tolist() == [
        B if t % 10 == 9 else 0 for t in range(steps)]


def _jax_epochs(key, batch, Tw):
    """The JAX package's fused paths' reset epochs for ``key``."""
    key_init, _ = jax.random.split(key)
    init_keys = jax.random.split(key_init, batch)
    return np.array(jax.vmap(lambda k: jax.random.randint(
        k, (), 0, Tw - 1))(init_keys))


def test_building_segment_ref_matches_jax_kernel(dicts):
    """The plain version of the port's episode kernel against the JAX
    package's fused_rollout (the Pallas kernel in interpret mode) on the
    same epochs and prescribed actions: every TimeStep field."""
    jp, tp = _params(dicts, episode_len=10)
    batch, steps, n = 256, 10, tp.n
    key = jax.random.PRNGKey(5)
    acts = (np.random.default_rng(6).uniform(-1, 1, (steps, batch, n))
            * tp.ac_map.numpy()).astype(np.float32)
    jroll = jb.BuildingEnv().fused_rollout(
        jp, key, batch, steps, actions=jnp.asarray(acts), il=2, width=128,
        interpret=True)
    epochs = torch.from_numpy(_jax_epochs(key, batch,
                                          tp.length_of_weather)).long()
    launches = K5.building_segment.launches
    out = K5.building_segment(tp, epochs, steps,
                              actions=torch.from_numpy(acts),
                              record_actions=True)
    assert K5.building_segment.launches == launches        # CPU: plain
    np.testing.assert_array_equal(out["actions"].numpy(), acts)
    np.testing.assert_allclose(out["reward"].numpy(),
                               np.asarray(jroll.reward), **KERNEL_TOL)
    for k in ("zone_temperature", "comfort_level", "power_consumption"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jroll.info[k]),
                                   **KERNEL_TOL, err_msg=k)
    # the last obs of the JAX rollout is its autoreset splice
    np.testing.assert_allclose(out["obs"][:-1].numpy(),
                               np.asarray(jroll.obs[:-1]), **KERNEL_TOL)


def test_fused_rollout_splices_and_matches_batch_unroll(dicts):
    """fused_rollout on prescribed actions and epochs (CPU: the plain
    version of the episode kernel) across two episode boundaries: done at
    the boundaries only, the next reset obs spliced into the last obs while
    the zone temperatures keep the step's own; equal to batch_unroll on the
    same inputs to the kernel's bound (the two step expressions differ in
    rounding); RNG mode reproducible from the generator."""
    _, tp = _params(dicts, episode_len=10)
    env, n = tb.BuildingEnv(), tp.n
    rng = np.random.default_rng(7)
    B, T = 16, 25
    epochs = rng.integers(0, tp.length_of_weather - 1, (3, B))
    acts = torch.from_numpy((rng.uniform(-1, 1, (T, B, n))
                             * tp.ac_map.numpy()).astype(np.float32))
    launches = (K5.building_segment.launches, KA.episode_slice_gather.launches)
    fused = env.fused_rollout(tp, B, T, actions=acts, epochs=epochs)
    assert (K5.building_segment.launches,
            KA.episode_slice_gather.launches) == launches   # CPU: plain
    step = iter(range(T))
    unroll = env.batch_unroll(tp, lambda _, obs, g: acts[next(step)], None,
                              B, T, epochs=epochs)
    np.testing.assert_allclose(fused.reward.numpy(), unroll.reward.numpy(),
                               **KERNEL_TOL)
    np.testing.assert_allclose(fused.obs.numpy(), unroll.obs.numpy(),
                               **KERNEL_TOL)
    for k in unroll.info:
        np.testing.assert_allclose(fused.info[k].numpy(),
                                   unroll.info[k].numpy(), **KERNEL_TOL,
                                   err_msg=k)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(fused, name).numpy(),
                                      getattr(unroll, name).numpy())
    terms = fused.terminated.numpy()
    assert terms[9].all() and terms[19].all()
    assert not terms[[0, 5, 10, 15, 20, 24]].any()
    reset_obs = env.reset_at_epoch(tp, torch.from_numpy(epochs[1]))[1].obs
    assert torch.equal(fused.obs[9], reset_obs)
    assert not torch.equal(fused.info["zone_temperature"][9],
                           fused.obs[9, :, :n])
    r1 = env.fused_rollout(tp, 8, 25, generator=torch.Generator().manual_seed(5))
    r2 = env.fused_rollout(tp, 8, 25, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(r1.reward.numpy(), r2.reward.numpy())
    assert np.isfinite(r1.obs.numpy()).all()
    assert r1.reward[10:20].std() > 0


def _jax_policy(n, H, seed):
    rng = np.random.default_rng(seed)
    D = n + 4

    def dense(din, dout):
        return {"w": rng.normal(0, 0.3, (din, dout)).astype(np.float32),
                "b": rng.normal(0, 0.1, (dout,)).astype(np.float32)}

    return {"trunk1": dense(D, H), "trunk2": dense(H, H), "mu": dense(H, n),
            "value": dense(H, 1),
            "log_std": np.full((n,), -0.5, np.float32)}


def test_building_policy_segment_ref_matches_jax_kernel(dicts):
    """The plain version of the policy kernel against the JAX package's
    fused_policy_unroll (the Pallas policy kernel in interpret mode) on
    from_jax weights, the same epochs and prescribed noise, with the JAX
    package's bounds for its kernel (tests/test_ops_pallas.py:461-478): the
    dynamics feed the policy, so bf16 flips separate trajectories late in
    the episode; the first 32 steps are held per entry, the whole episode
    by its reward statistics."""
    jp, tp = _params(dicts, episode_len=48)
    n, batch, T, H = tp.n, 128, 48, 32
    tree = _jax_policy(n, H, 9)
    noise = np.random.default_rng(10).standard_normal((T, batch, 8)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    jout = jb.BuildingEnv().fused_policy_unroll(
        jp, jax.tree.map(jnp.asarray, tree), key, batch, T, w=128,
        noise=jnp.asarray(noise), interpret=True)
    blk = np.asarray(jout["obs_blk_k"], np.float32)     # (T, 24, 128)

    def rows(lo, k):
        return np.swapaxes(blk[:, lo:lo + k, :], 1, 2)   # (T, B, k)

    epochs = torch.as_tensor(np.array(jout["epochs"])).long()
    weights = pack_policy_weights(from_jax(tree, device="cpu"))
    out, lrn = K5.building_policy_segment(
        tp, weights, epochs, T, noise=torch.from_numpy(noise[..., :n]))
    assert out.shape == (T, batch, 3) and lrn.dtype == torch.bfloat16
    lrn = lrn.float().numpy()
    E = 32
    dx = np.abs(lrn[..., :n] - rows(0, n))
    assert np.quantile(dx[:E], 0.99) < 0.05, np.quantile(dx[:E], 0.99)
    np.testing.assert_allclose(lrn[:E, :, n:n + 4], rows(8, 4)[:E],
                               atol=2e-3, rtol=1e-2)
    du = np.abs(lrn[..., n + 4:] - rows(16, n))
    assert np.quantile(du[:E], 0.99) < 0.05, np.quantile(du[:E], 0.99)
    rew_t, rew_j = out[..., 0].numpy(), np.asarray(jout["reward"])
    dr = np.abs(rew_t - rew_j)
    assert np.quantile(dr[:E], 0.99) < 0.02, np.quantile(dr[:E], 0.99)
    assert abs(rew_t.mean() - rew_j.mean()) < 5e-3
    assert abs(rew_t.std() - rew_j.std()) < 2e-2
    for i, k in ((1, "comfort_cost"), (2, "power_cost")):
        dk = np.abs(out[..., i].numpy() - np.asarray(jout[k]))
        assert np.quantile(dk[:E], 0.99) < 0.02, k


def _spy(env, name, calls):
    fn = getattr(env, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    setattr(env, name, wrapped)


@pytest.mark.parametrize("obs_bf16,path", [(True, "fused_policy_unroll"),
                                           (False, "batch_unroll")])
def test_ppo_lr0_on_both_paths(dicts, obs_bf16, path):
    """PPO on building: bf16 obs take the fused policy-in-kernel path,
    float32 obs the episodic batch_unroll path (the repaired gate); with
    lr=0 every ratio is exactly 1, so pg_loss vanishes."""
    _, tp = _params(dicts, episode_len=24)
    env, calls = tb.BuildingEnv(), []
    _spy(env, "fused_policy_unroll", calls)
    _spy(env, "batch_unroll", calls)
    cfg = PPOConfig(num_envs=64, hidden=32, minibatches=4, epochs=1, lr=0.0,
                    obs_bf16=obs_bf16)
    init_state, train_step = make_train_step(env, tp, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    w0 = carry["policy"].trunk1.weight.detach().clone()
    carry, metrics = train_step(carry, gen)
    m = {k: float(v) for k, v in metrics.items()}
    assert calls == [path]
    assert abs(m["pg_loss"]) < 1e-5, m
    assert np.isfinite(m["vf_loss"]) and m["vf_loss"] > 0
    assert m["episode_done_frac"] == pytest.approx(1.0 / 24)
    assert torch.equal(carry["policy"].trunk1.weight, w0)


def test_ppo_gate_other_configurations(dicts):
    """A building configuration the kernels do not compute takes the
    episodic path even with bf16 obs; discrete actions train on the
    categorical head where their bins are uniform and raise the JAX
    package's error where they are not; EV with float32 obs takes the
    episodic path (its batch_unroll)."""
    jd, td = dicts
    tp = tb.make_params({**td, "episode_len": 24, "reward_pnorm": 1},
                        device="cpu")
    env, calls = tb.BuildingEnv(), []
    _spy(env, "batch_unroll", calls)
    assert not env.fused_policy_unroll_supported(tp, 64)
    init_state, train_step = make_train_step(
        env, tp, PPOConfig(num_envs=16, hidden=16, minibatches=2, epochs=1,
                           obs_bf16=True))
    gen = torch.Generator().manual_seed(1)
    train_step(init_state(gen), gen)
    assert calls == ["batch_unroll"]
    # discrete actions: uniform bins (2 ac 100 = 200 per zone here) train
    # on the categorical head, the lr=0 ratio exact; bins that differ by
    # zone raise as the JAX package raises
    _, tpd = _params(dicts, episode_len=24, is_continuous_action=False)
    assert tb.BuildingEnv().action_space(tpd).nvec.tolist() == [200] * 6
    init_state, train_step = make_train_step(
        tb.BuildingEnv(), tpd, PPOConfig(num_envs=8, hidden=16,
                                         minibatches=2, epochs=1, lr=0.0,
                                         obs_bf16=True))
    _, m = train_step(init_state(gen), gen)
    assert abs(float(m["pg_loss"])) < 1e-5, m
    ac = np.array(jd["ac_map"], dtype=np.float64)
    ac[1] = 0.5
    jpn, tpn = _params(dicts, is_continuous_action=False, ac_map=ac)
    with pytest.raises(ValueError, match="uniform bins") as theirs:
        jppo.make_train_step(jb.BuildingEnv(), jpn, jppo.PPOConfig())
    with pytest.raises(ValueError, match="uniform bins") as ours:
        make_train_step(tb.BuildingEnv(), tpn, PPOConfig())
    assert str(ours.value) == str(theirs.value)
    ev, evp = make("evcharging", site="caltech", project_action=False,
                   device="cpu")
    _, ev_step = make_train_step(ev, evp, PPOConfig(obs_bf16=False))
    assert ev_step.path == "episodic"


def test_train_cli_building(tables, tmp_path):
    """One tiny iteration of ``train.py --env building`` on the synthetic
    tables (hourly steps, 24-step episodes), on the fused path."""
    from sustaingym_tpu_torch import train
    root, htm, epw = tables
    kw = {"building": htm, "weather": epw, "root": root,
          "u_wall": list(tb.BUILDINGS["OfficeSmall"][1]), "time_res": 3600,
          "episode_len": 24}
    train.main(["--env", "building", "--device", "cpu", "--num-envs", "16",
                "--hidden", "16", "--minibatches", "2", "--epochs", "1",
                "--iterations", "1", "--obs-bf16", "--log-dir",
                str(tmp_path), "--env-kwargs", json.dumps(kw)])
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert len(rows) == 2 and "pg_loss" in rows[0]


def test_building_entry_points_default_to_the_card(dicts):
    """make("building"), make_params and make_env build on the card unless
    asked for the CPU; without a card the default raises instead of moving
    to the CPU (before any table is read)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make("building")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.make_params(dicts[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.make_env()


def test_raw_tables_resolve_by_path(tables, monkeypatch):
    """The named prototype and climate read the raw tables from the first
    existing raw-data root; without one both packages raise the same
    FileNotFoundError."""
    import os
    import shutil

    from sustaingym_tpu_torch.data import paths
    root, htm, epw = tables
    monkeypatch.setattr(paths, "_DEFAULT_RAW_CANDIDATES", ("",))
    with pytest.raises(FileNotFoundError, match="SUSTAINGYM_RAW") as ours:
        tb.make_env(device="cpu")
    try:
        jb.make_env()
    except FileNotFoundError as theirs:   # no raw tables for the JAX one
        assert str(ours.value) == str(theirs)
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "building"), exist_ok=True)
    shutil.copy(os.path.join(root, htm), os.path.join(
        raw, "building", tb.BUILDINGS["OfficeSmall"][0]))
    shutil.copy(os.path.join(root, epw), os.path.join(
        raw, "building", tb.WEATHER["Hot_Dry"]))
    monkeypatch.setattr(paths, "_DEFAULT_RAW_CANDIDATES", ("", raw))
    assert paths.raw_root() == raw
    _, tp = tb.make_env(device="cpu")
    _, ref = _params(_dicts(tables))
    np.testing.assert_array_equal(tp.A_d.numpy(), ref.A_d.numpy())


@pytest.mark.parametrize("flip,verdict", [
    (5, "a bf16 flip comes first"), (9, "no flip comes first"),
    (None, "learner block equal at every step")])
def test_policy_drift_finds_the_first_flip(flip, verdict):
    """chip_smoke.policy_drift names the most drifting env, the step where
    its |d reward| first passes 1e-3 (7 here) and the first differing
    learner-block entry, and says whether that flip comes first."""
    T, B, n = 12, 3, 2
    ko, ro = torch.zeros((T, B, 3)), torch.zeros((T, B, 3))
    kl = torch.zeros((T, B, 2 * n + 4), dtype=torch.bfloat16)
    rl = kl.clone()
    ko[6:, 1, 0] = torch.linspace(1e-4, 0.5, T - 6)
    ko[9, 2, 0] = 0.1
    if flip is not None:
        kl[flip, 1, n + 4 + 1] = 0.5                   # u[1]
    msg = chip_smoke.policy_drift(n, (ko, kl), (ro, rl))
    assert msg.startswith("env 1: |d reward| first > 1e-3 at step 7;")
    if flip is not None:
        assert f"first differs at step {flip} in u[1] 0.5 vs 0" in msg
    assert msg.endswith(verdict)


def _present_batch_unroll(env, p, policy, batch, num_steps, generator):
    """BuildingEnv.batch_unroll as one loop over every step, as it was
    before its step loop became the part a CUDA graph captures."""
    from sustaingym_tpu_torch.core import TimeStep, tree_stack
    L = p.episode_len
    e0 = env._episode_epochs(p, 0, batch, generator, None)
    state, ts = env.reset_at_epoch(p, e0)
    x, obs, traj = state.x, ts.obs, []
    for ep, t0 in enumerate(range(0, num_steps, L)):
        seg = min(L, num_steps - t0)
        block = KA.episode_slice_gather(p.exog, state.epoch,
                                        seg).transpose(0, 1)
        no = torch.zeros(batch, dtype=torch.bool)
        for t in range(seg):
            actions = policy(None, obs, generator)
            x, _, reward, obs, info = env._step_exog(p, x, actions, block[t])
            done = no | (t == L - 1)
            traj.append(TimeStep(obs=obs, reward=reward, terminated=done,
                                 truncated=done.clone(), info=info))
        if seg == L:
            state, ts_r = env.reset_at_epoch(p, env._episode_epochs(
                p, ep + 1, batch, generator, None))
            x, obs = state.x, ts_r.obs
            traj[-1] = replace(traj[-1], obs=obs)
    return tree_stack(traj)


@pytest.mark.parametrize("continuous", [True, False])
def test_split_batch_unroll_matches_the_present_loop(dicts, continuous):
    """batch_unroll split into an eager episode start and a step loop
    (_episode_steps, which a CUDA graph captures on the card), called
    directly and through a CPU Graphs, against the loop it replaces: bit
    for bit across two episode boundaries, with Box and MultiDiscrete
    actions."""
    from sustaingym_tpu_torch.core import tree_map
    from sustaingym_tpu_torch.core.graph import Graphs
    _, tp = _params(dicts, episode_len=10, is_continuous_action=continuous)
    env, B, T = tb.BuildingEnv(), 4, 25
    policy = random_policy(env, tp, B)
    want = _present_batch_unroll(env, tp, policy, B, T,
                                 torch.Generator().manual_seed(3))
    for graphs in (None, Graphs("cpu")):
        got = env.batch_unroll(tp, policy, None, B, T,
                               torch.Generator().manual_seed(3),
                               graphs=graphs)
        tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                            b.numpy()),
                 got, want)
