"""PyTorch port of EVChargingEnv (sustaingym_tpu_torch.envs.evcharging)
against the JAX package on the same packed data, days and actions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.envs import evcharging as jev
from sustaingym_tpu.ops import qp as jqp
from sustaingym_tpu.core import flatten as jflatten
from sustaingym_tpu_torch.core import flatdim, flatten, replace
from sustaingym_tpu_torch.envs import evcharging as tev


@pytest.fixture(scope="module", params=["caltech", "jpl"])
def both(request):
    """(site, (jax env, params), (torch env, params)), projection on; the
    JAX operator runs its f32 chain (inner_bf16=False) like the port."""
    site = request.param
    jenv, jp = jev.make_env(site=site)
    spec = jev.load_site(site)
    jp = jp.replace(proj=jqp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        action_scale=32.0, iters=15, inner_bf16=False))
    tenv, tp = tev.make_env(site=site, device="cpu")
    return site, (jenv, jp), (tenv, tp)


def test_make_params_matches_jax(both):
    _, (_, jp), (_, tp) = both
    for name in ("step_table", "moer", "constraint_re", "constraint_im",
                 "magnitudes", "min_pilots", "day_max_profit", "day_num_evs"):
        np.testing.assert_allclose(
            getattr(tp, name).numpy().astype(np.float64),
            np.asarray(getattr(jp, name), np.float64), rtol=0, atol=1e-6,
            err_msg=name)
    for name in ("C", "radii", "step"):
        np.testing.assert_allclose(getattr(tp.proj, name).numpy(),
                                   np.asarray(getattr(jp.proj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert (tp.n_stations, tp.n_days, tp.moer_forecast_steps) \
        == (jp.n_stations, jp.n_days, jp.moer_forecast_steps)
    assert tp.step_table.dtype == torch.float32


def test_spaces_match_jax(both):
    _, (jenv, jp), (tenv, tp) = both
    jspace, tspace = jenv.observation_space(jp), tenv.observation_space(tp)
    assert list(jspace.spaces) == list(tspace.spaces)
    for k in jspace.spaces:
        assert jspace[k].shape == tspace[k].shape
        np.testing.assert_array_equal(jspace[k].low, tspace[k].low)
    assert jenv.action_space(jp).shape == tenv.action_space(tp).shape


def test_quantize_pilots_half_even():
    """Round half to even like jnp.round: 4 A on an AV station is
    4/8 = 0.5 -> 0 A, 20 A -> 2.5 -> 16 A; CC 6.5 A -> 6 A, 7.5 A -> 8 A."""
    amps = np.array([4.0, 12.0, 20.0, 28.0, 6.5, 7.5, 5.9, 6.0, 32.0, 0.0],
                    np.float32)
    minp = np.array([8, 8, 8, 8, 6, 6, 6, 6, 8, 6], np.float32)
    a = amps / 32.0
    got = tev.quantize_pilots(torch.from_numpy(a), torch.from_numpy(minp))
    np.testing.assert_array_equal(
        got.numpy(), [0, 16, 16, 32, 6, 8, 0, 6, 32, 0])
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (64, 54)).astype(np.float32)
    minp = np.where(rng.uniform(size=54) < 0.3, 6.0, 8.0).astype(np.float32)
    np.testing.assert_array_equal(
        tev.quantize_pilots(torch.from_numpy(a), torch.from_numpy(minp)),
        np.asarray(jev.quantize_pilots(jnp.asarray(a), jnp.asarray(minp))))


def test_battery_charge_matches_jax():
    rng = np.random.default_rng(1)
    pil = (rng.integers(0, 5, (64, 54)) * 8).astype(np.float32)
    dem = rng.uniform(0, 60, (64, 54)).astype(np.float32)
    dem[:, :5] = rng.uniform(0, 1, (64, 5))   # the taper and period caps
    plugged = rng.uniform(size=(64, 54)) < 0.7
    rt, et = tev.battery_charge(torch.from_numpy(pil), torch.from_numpy(dem),
                                torch.from_numpy(plugged))
    rj, ej = jev.battery_charge(jnp.asarray(pil), jnp.asarray(dem),
                                jnp.asarray(plugged))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("t0", [0, 96])
@pytest.mark.parametrize("project", [True, False])
def test_step_loop_matches_jax(both, project, t0):
    """12 batched steps from reset_at_day on the same days and actions,
    from midnight and (clock set forward on the empty reset state) from
    08:00, when sessions arrive and the cones bind."""
    site, (jenv, jp), (tenv, tp) = both
    jp = jp.replace(project_action=project)
    tp = replace(tp, project_action=project)
    batch, steps, n = 64, 12, tp.n_stations
    rng = np.random.default_rng(7)
    days = rng.integers(0, tp.n_days, batch)
    actions = rng.uniform(0, 1, (steps, batch, n)).astype(np.float32)

    jstate, jts = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    jstate = jstate.replace(t=jnp.full((batch,), t0, jnp.int32))
    tstate, tts = tenv.reset_at_day(tp, torch.from_numpy(days))
    tstate.t = torch.full((batch,), t0, dtype=torch.long)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    for t in range(steps):
        jstate, jts = vstep(jp, jstate, jnp.asarray(actions[t]),
                            jax.random.PRNGKey(0))
        tstate, tts = tenv.step(tp, tstate, torch.from_numpy(actions[t]))
        tol = dict(rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tts.reward.numpy(),
                                   np.asarray(jts.reward), **tol)
        for k in ("profit", "carbon_cost", "excess_charge", "max_profit"):
            np.testing.assert_allclose(tts.info[k].numpy(),
                                       np.asarray(jts.info[k]), **tol,
                                       err_msg=k)
        for k in jts.obs:
            np.testing.assert_allclose(tts.obs[k].numpy(),
                                       np.asarray(jts.obs[k]), **tol,
                                       err_msg=k)
        np.testing.assert_array_equal(tstate.plugged.numpy(),
                                      np.asarray(jstate.plugged))
        np.testing.assert_array_equal(tts.terminated.numpy(),
                                      np.asarray(jts.terminated))
    if t0:   # the loop exercised arrivals and charging
        assert tstate.plugged.any() and float(tts.info["profit"].sum()) > 0


def test_flatten_order_and_reset_match_jax(both):
    """The flat obs order (DictSpace insertion order) equals the JAX
    package's, so converted trunk1 rows line up; reset draws valid days."""
    _, (jenv, jp), (tenv, tp) = both
    days = np.array([0, 5, 17, tp.n_days - 1])
    jstate, jts = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    rng = np.random.default_rng(4)
    acts = rng.uniform(0, 1, (len(days), tp.n_stations)).astype(np.float32)
    jstate = jstate.replace(t=jnp.full((len(days),), 100, jnp.int32))
    _, jts = jax.vmap(jenv.step, in_axes=(None, 0, 0, None))(
        jp, jstate, jnp.asarray(acts), jax.random.PRNGKey(0))
    tstate, _ = tenv.reset_at_day(tp, torch.from_numpy(days))
    tstate.t = torch.full((len(days),), 100, dtype=torch.long)
    _, tts = tenv.step(tp, tstate, torch.from_numpy(acts))
    space = tenv.observation_space(tp)
    flat = flatten(space, tts.obs, batch_dims=1)
    jflat = jax.vmap(lambda o: jflatten(jenv.observation_space(jp), o))(
        jts.obs)
    assert flat.shape == (len(days), flatdim(space)) == jflat.shape
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=2e-4,
                               atol=2e-5)
    _, ts = tenv.reset(tp, torch.Generator().manual_seed(0), 256)
    mp = ts.info["max_profit"]
    assert mp.shape == (256,) and torch.isin(mp, tp.day_max_profit).all()


@pytest.fixture(scope="module", params=["caltech", "jpl"])
def admm(request):
    """(site, (jax env, params), (torch env, params)) with the ADMM
    operator (proj_method="admm", 30 iterations)."""
    site = request.param
    return (site, jev.make_env(site=site, proj_method="admm"),
            tev.make_env(site=site, proj_method="admm", device="cpu"))


@pytest.mark.parametrize("t0", [0, 96])
def test_admm_step_loop_matches_jax(admm, t0):
    """test_step_loop_matches_jax with the ADMM operator: 12 batched steps
    on the same days and actions, from midnight and from 08:00, with the
    same tolerances."""
    site, (jenv, jp), (tenv, tp) = admm
    assert isinstance(tp.proj, tev.env.qp.SOCProjection)
    batch, steps, n = 64, 12, tp.n_stations
    rng = np.random.default_rng(7)
    days = rng.integers(0, tp.n_days, batch)
    actions = rng.uniform(0, 1, (steps, batch, n)).astype(np.float32)
    jstate, _ = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    jstate = jstate.replace(t=jnp.full((batch,), t0, jnp.int32))
    tstate, _ = tenv.reset_at_day(tp, torch.from_numpy(days))
    tstate.t = torch.full((batch,), t0, dtype=torch.long)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    tol = dict(rtol=2e-4, atol=2e-5)
    for t in range(steps):
        jstate, jts = vstep(jp, jstate, jnp.asarray(actions[t]),
                            jax.random.PRNGKey(0))
        tstate, tts = tenv.step(tp, tstate, torch.from_numpy(actions[t]))
        np.testing.assert_allclose(tts.reward.numpy(),
                                   np.asarray(jts.reward), **tol)
        for k in ("profit", "carbon_cost", "excess_charge"):
            np.testing.assert_allclose(tts.info[k].numpy(),
                                       np.asarray(jts.info[k]), **tol,
                                       err_msg=k)
        for k in jts.obs:
            np.testing.assert_allclose(tts.obs[k].numpy(),
                                       np.asarray(jts.obs[k]), **tol,
                                       err_msg=k)
        np.testing.assert_array_equal(tstate.plugged.numpy(),
                                      np.asarray(jstate.plugged))
    if t0:
        assert tstate.plugged.any() and float(tts.info["profit"].sum()) > 0


def _timed_policy_jax(_, obs, key):
    """A deterministic policy of exact table inputs only (the clock and the
    MOER), so both packages see the same actions."""
    n = obs["demands"].shape[-1]
    ramp = jnp.linspace(0.1, 0.9, n, dtype=jnp.float32)
    a = ramp[None, :] * (0.5 + obs["timestep"]) + obs["prev_moer"]
    return jnp.clip(a, 0.0, 1.0)


def _timed_policy_torch(_, obs, generator):
    n = obs["demands"].shape[-1]
    ramp = torch.linspace(0.1, 0.9, n, dtype=torch.float32)
    a = ramp[None, :] * (0.5 + obs["timestep"]) + obs["prev_moer"]
    return torch.clamp(a, 0.0, 1.0)


def test_batch_unroll_matches_jax():
    """The lockstep batch_unroll against the JAX package's on the days the
    JAX key draws (the first episode's and the autoreset's at step 287),
    a deterministic policy, 288 + 5 steps across the episode boundary,
    projection off (the projections are held in their own tests). Demands
    that charge to zero keep a residue of their last rounding (~1e-6, not
    the same in both packages), hence atol 2e-5 (the step-loop tests')
    beside rtol 2e-5."""
    site = "caltech"
    jenv, jp = jev.make_env(site=site, project_action=False)
    tenv, tp = tev.make_env(site=site, project_action=False, device="cpu")
    B, T = 6, jev.env.MAX_TIMESTEP + 5
    key = jax.random.PRNGKey(9)
    want = jenv.batch_unroll(jp, _timed_policy_jax, None, key, B, T)
    key_init, key_scan = jax.random.split(key)
    days0 = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), 0, jp.n_days))(jax.random.split(key_init, B)))
    _, key_env = jax.random.split(jax.random.split(key_scan, T)[287])
    days1 = np.asarray(jenv._autoreset_days(jp, key_env, B))
    got = tenv.batch_unroll(tp, _timed_policy_torch, None, B, T,
                            days=torch.from_numpy(np.stack([days0, days1])))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward),
                               **tol)
    np.testing.assert_array_equal(got.terminated.numpy(),
                                  np.asarray(want.terminated))
    for k in want.obs:
        np.testing.assert_allclose(got.obs[k].numpy(),
                                   np.asarray(want.obs[k]), **tol, err_msg=k)
    for k in ("profit", "carbon_cost", "excess_charge", "max_profit"):
        np.testing.assert_allclose(got.info[k].numpy(),
                                   np.asarray(want.info[k]), **tol, err_msg=k)
    assert float(got.info["profit"].sum()) > 0
    with pytest.raises(ValueError, match="episodes"):
        tenv.batch_unroll(tp, _timed_policy_torch, None, B, T,
                          days=torch.from_numpy(days0))


@pytest.mark.parametrize("proj_method", ["dual", "admm"])
def test_batch_unroll_matches_batch_rollout_generic(proj_method):
    """batch_unroll against batch_rollout(fast=False) (env.step under
    autoreset) from one generator seed, projection on, 288 + 5 steps:
    the same reset draws in the same order, so the same trajectories
    (tolerance of tests/test_evcharging.py::test_batch_unroll_matches_
    generic; here they are bit-equal)."""
    from sustaingym_tpu_torch.core import batch_rollout, random_policy
    env, p = tev.make_env(site="jpl", proj_method=proj_method, proj_iters=6,
                          device="cpu")
    B, T = 4, 288 + 5
    policy = random_policy(env, p, B)
    fast = batch_rollout(env, p, policy, None,
                         torch.Generator().manual_seed(42), B, T)
    slow = batch_rollout(env, p, policy, None,
                         torch.Generator().manual_seed(42), B, T,
                         fast=False)
    tol = dict(rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(fast.reward.numpy(), slow.reward.numpy(),
                               **tol)
    np.testing.assert_array_equal(fast.terminated.numpy(),
                                  slow.terminated.numpy())
    for k in slow.obs:
        np.testing.assert_allclose(fast.obs[k].numpy(), slow.obs[k].numpy(),
                                   **tol, err_msg=k)
    for k in slow.info:
        np.testing.assert_allclose(fast.info[k].numpy(),
                                   slow.info[k].numpy(), **tol, err_msg=k)
    assert fast.terminated[287].all() and not fast.terminated[288:].any()


def test_single_env_rollout():
    """core.rollout: one env, unbatched obs and actions for the policy,
    the trajectory and final state without the env axis; the same steps as
    batch_rollout(fast=False) of one env from the same generator seed."""
    from sustaingym_tpu_torch.core import batch_rollout, rollout
    env, p = tev.make_env(site="caltech", device="cpu")
    T, seen = 290, []

    def policy(_, obs, generator):
        seen.append(obs["demands"].shape)
        return torch.full((p.n_stations,), 0.6)

    state, traj = rollout(env, p, policy, None,
                          torch.Generator().manual_seed(5), T)
    assert set(seen) == {(p.n_stations,)}
    assert traj.reward.shape == (T,) and traj.obs["demands"].shape == (
        T, p.n_stations)
    assert state.plugged.shape == (p.n_stations,) and int(state.t) == 2
    assert bool(traj.terminated[287]) and int(traj.terminated.sum()) == 1
    batch = batch_rollout(env, p, lambda _, o, g: torch.full(
        (1, p.n_stations), 0.6), None, torch.Generator().manual_seed(5), 1,
        T, fast=False)
    np.testing.assert_array_equal(traj.reward.numpy(),
                                  batch.reward[:, 0].numpy())
    np.testing.assert_array_equal(traj.obs["demands"].numpy(),
                                  batch.obs["demands"][:, 0].numpy())


def test_fused_policy_unroll_supported_is_false_for_admm():
    """The policy kernel has no ADMM branch: PPO takes the episodic path,
    and the kernel's wrapper refuses the operator."""
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    env, p = tev.make_env(site="caltech", proj_method="admm", device="cpu")
    _, pd = tev.make_env(site="caltech", device="cpu")
    assert not env.fused_policy_unroll_supported(p, 8192)
    assert env.fused_policy_unroll_supported(pd, 8192)
    with pytest.raises(ValueError, match="ADMM"):
        K.ev_policy_segment(p, None, torch.tensor([0]), 4)
    with pytest.raises(ValueError, match="proj_method"):
        tev.make_params(proj_method="exact", device="cpu")
