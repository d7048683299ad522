"""Plain PyTorch versions of the two EV episode kernels
(sustaingym_tpu_torch.ops.cuda.ev_rollout), driven through
EVChargingEnv.fused_rollout / fused_policy_unroll on the CPU, against the
JAX package: its Pallas kernel in interpret mode, its step loop, and the
op-mirrored policy reference of tests/test_ops_pallas.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.envs import evcharging as jev
from sustaingym_tpu.ops import qp as jqp
from sustaingym_tpu_torch.envs import evcharging as tev
from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
from sustaingym_tpu_torch.parallel import from_jax


def _jax_days(key, params, batch):
    """fused_rollout's reset-day derivation in the JAX package."""
    key_init, _ = jax.random.split(key)
    init_keys = jax.random.split(key_init, batch)
    return np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), 0, params.n_days))(init_keys))


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_ev_segment_ref_matches_jax(site):
    """ev_segment's plain version == the JAX Pallas kernel (interpret mode)
    and the JAX step loop, on the same days and actions (projection on, the
    JAX operator on its f32 chain like the kernels)."""
    jenv, jp = jev.make_env(site=site, project_action=True, proj_iters=15)
    spec = jev.load_site(site)
    jp = jp.replace(proj=jqp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        action_scale=32.0, iters=15, inner_bf16=False))
    tenv, tp = tev.make_env(site=site, project_action=True, device="cpu")
    n = tp.n_stations
    batch, steps = 128, 12
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(5)
    actions = rng.uniform(0, 1, (steps, batch, n)).astype(np.float32)

    fused = jenv.fused_rollout(jp, key, batch, steps,
                               actions=jnp.asarray(actions), w=128,
                               interpret=True)
    days = _jax_days(key, jp, batch)
    state, _ = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    loop = {"reward": [], "profit": [], "carbon_cost": [],
            "excess_charge": []}
    for t in range(steps):
        state, ts = vstep(jp, state, jnp.asarray(actions[t]),
                          jax.random.PRNGKey(0))
        loop["reward"].append(np.asarray(ts.reward))
        for k in ("profit", "carbon_cost", "excess_charge"):
            loop[k].append(np.asarray(ts.info[k]))

    before = K.ev_segment.launches
    out = tenv.fused_rollout(tp, batch, steps, days=torch.tensor(days),
                             actions=torch.from_numpy(actions))
    assert K.ev_segment.launches == before   # CPU: the plain version
    assert out.reward.shape == (steps, batch)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(fused.reward),
                               **tol)
    np.testing.assert_allclose(out.reward.numpy(), np.stack(loop["reward"]),
                               **tol)
    for k in ("profit", "carbon_cost", "excess_charge"):
        np.testing.assert_allclose(out.info[k].numpy(),
                                   np.asarray(fused.info[k]), **tol)
        np.testing.assert_allclose(out.info[k].numpy(), np.stack(loop[k]),
                                   **tol)
    np.testing.assert_allclose(out.info["max_profit"].numpy(),
                               np.asarray(fused.info["max_profit"]), **tol)


def test_fused_rollout_multi_episode_and_rng():
    """Episodes past 288 steps restart from the next row of days;
    generator-driven rollouts are reproducible and U[0, 1)-driven."""
    tenv, tp = tev.make_env(site="caltech", project_action=False,
                            device="cpu")
    batch, steps = 8, 300
    days = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [7, 6, 5, 4, 3, 2, 1, 0]])
    rng = np.random.default_rng(2)
    acts = rng.uniform(0, 1, (steps, batch, tp.n_stations)).astype(
        np.float32)
    out = tenv.fused_rollout(tp, batch, steps, days=torch.from_numpy(days),
                             actions=torch.from_numpy(acts))
    assert out.reward.shape == (steps, batch)
    assert out.terminated[287].all() and not out.terminated[:287].any()
    # the second episode restarts from reset on its own days
    second, _ = K.ev_segment_ref(tp, torch.from_numpy(days[1]), 12,
                                 actions=torch.from_numpy(acts[288:]))
    np.testing.assert_array_equal(out.reward[288:].numpy(),
                                  second[..., 0].numpy())
    with pytest.raises(ValueError):
        tenv.fused_rollout(tp, batch, steps, days=torch.from_numpy(days[0]),
                           actions=torch.from_numpy(acts))
    r1 = tenv.fused_rollout(tp, batch, 20,
                            generator=torch.Generator().manual_seed(3))
    r2 = tenv.fused_rollout(tp, batch, 20,
                            generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(r1.reward.numpy(), r2.reward.numpy())
    _, a = K.ev_segment_ref(tp, torch.arange(8), 20, seed=1,
                            record_actions=True)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.05


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_ev_policy_segment_ref_matches_jax_reference(site):
    """ev_policy_segment's plain version == the op-mirrored JAX reference of
    tests/test_ops_pallas.py (obs assembly, bf16 actor, Gaussian sampling,
    tanh squash, env stepping), projection off, with that test's bounds:
    rare pilot-quantization flips from reassociation drift are bounded by
    quantiles, not the max."""
    jenv, jp = jev.make_env(site=site, project_action=False)
    tenv, tp = tev.make_env(site=site, project_action=False, device="cpu")
    n = tp.n_stations
    batch, T, H = 128, 288, 64
    D = 2 + 2 * n + 36
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((T, batch, n)).astype(np.float32)
    f32 = np.float32
    policy = {
        "trunk1": {"w": rng.normal(0, 0.3, (D, H)).astype(f32),
                   "b": rng.normal(0, 0.1, (H,)).astype(f32)},
        "trunk2": {"w": rng.normal(0, 0.3, (H, H)).astype(f32),
                   "b": rng.normal(0, 0.1, (H,)).astype(f32)},
        "mu": {"w": rng.normal(0, 0.3, (H, n)).astype(f32),
               "b": rng.normal(0, 0.1, (n,)).astype(f32)},
        "value": {"w": rng.normal(0, 0.3, (H, 1)).astype(f32),
                  "b": np.zeros(1, f32)},
        "log_std": np.full((n,), -0.5, f32),
    }
    days = rng.integers(0, tp.n_days, batch)

    out = tenv.fused_policy_unroll(tp, from_jax(policy, device="cpu"), batch,
                                   T, days=torch.from_numpy(days),
                                   noise=torch.from_numpy(noise))
    lay = tenv.fused_layout(tp)
    assert lay == {"width": D + n, "obs_cols": D, "u_lo": D}
    blk = out["lrn"].float().numpy()               # (T, B, D + n)
    assert out["lrn"].dtype == torch.bfloat16 and blk.shape == (T, batch,
                                                                D + n)

    # ---- JAX reference, op-mirrored --------------------------------------
    state, ts = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    bf = jnp.bfloat16
    jpol = jax.tree.map(jnp.asarray, policy)

    def actor(obs_flat):
        ob = obs_flat.astype(bf)
        h = jnp.tanh(jnp.matmul(ob, jpol["trunk1"]["w"].astype(bf),
                                preferred_element_type=jnp.float32)
                     + jpol["trunk1"]["b"])
        h = jnp.tanh(jnp.matmul(h.astype(bf), jpol["trunk2"]["w"].astype(bf),
                                preferred_element_type=jnp.float32)
                     + jpol["trunk2"]["b"])
        return (jnp.matmul(h.astype(bf), jpol["mu"]["w"].astype(bf),
                           preferred_element_type=jnp.float32)
                + jpol["mu"]["b"])

    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    jactor = jax.jit(actor)
    sigma = np.float32(np.exp(np.float32(-0.5)))
    rewards, obs_ref, u_ref = [], [], []
    obs = ts.obs
    for t in range(T):
        flat = jnp.concatenate(
            [obs["timestep"].astype(jnp.float32), obs["est_departures"],
             obs["demands"], obs["prev_moer"], obs["forecasted_moer"]],
            axis=1)
        u = jactor(flat) + sigma * jnp.asarray(noise[t])
        obs_ref.append(np.asarray(flat.astype(bf), np.float32))
        u_ref.append(np.asarray(u, np.float32))
        state, ts2 = vstep(jp, state, jnp.tanh(u) * 0.5 + 0.5,
                           jax.random.PRNGKey(0))
        rewards.append(np.asarray(ts2.reward))
        obs = ts2.obs
    obs_ref = np.stack(obs_ref)

    # est_departures, timestep and moer channels are action-independent
    np.testing.assert_array_equal(blk[..., 1:1 + n], obs_ref[..., 1:1 + n])
    np.testing.assert_array_equal(blk[..., 0], obs_ref[..., 0])
    np.testing.assert_array_equal(blk[..., 1 + 2 * n:D],
                                  obs_ref[..., 1 + 2 * n:D])
    dd = np.abs(blk[..., 1 + n:1 + 2 * n] - obs_ref[..., 1 + n:1 + 2 * n])
    assert np.mean(dd > 1e-3) < 0.01, np.mean(dd > 1e-3)
    du = np.abs(blk[..., D:] - np.stack(u_ref))
    assert np.quantile(du, 0.99) < 0.02, np.quantile(du, 0.99)
    dr = np.abs(out["reward"].numpy() - np.stack(rewards))
    assert np.quantile(dr, 0.99) < 1e-4, np.quantile(dr, 0.99)
    assert dr.mean() < 1e-4, dr.mean()
    assert out["done"][T - 1].all() and not out["done"][:T - 1].any()
    np.testing.assert_array_equal(out["days"].numpy(), days[None])


@pytest.mark.parametrize("D,H,n", [(37, 40, 21), (146, 256, 54), (10, 24, 6)])
def test_pack_policy_weights_fragment_order(D, H, n):
    """The actor's weights in the kernels' mma B-fragment order hold
    w1 / w2 / wm bit for bit: for column pair p, k16 step kc and lane
    4g + t, the eight values are rows 16 kc + 2t + (0, 1, 8, 9) of column
    16 p + g, then of column 16 p + 8 + g, zero outside (din, dout); D, H
    and n need not be multiples of 16."""
    from sustaingym_tpu_torch.parallel import init_policy
    w = K.pack_policy_weights(init_policy(D, n, H, torch.Generator()
                                          .manual_seed(D), "cpu"))
    for dense, frag in ((w.w1, w.w1f), (w.w2, w.w2f), (w.wm, w.wmf)):
        din, dout = dense.shape
        kp, np_ = -(-din // 16) * 16, -(-dout // 16) * 16
        assert frag.dtype == torch.bfloat16
        assert frag.shape == (np_ // 16, kp // 16, 32, 8)
        p, kc, lane, q = np.meshgrid(np.arange(np_ // 16),
                                     np.arange(kp // 16), np.arange(32),
                                     np.arange(8), indexing="ij")
        g, t = lane // 4, lane % 4
        row = 16 * kc + 2 * t + (q & 1) + 8 * ((q >> 1) & 1)
        col = 16 * p + g + 8 * (q >> 2)
        padded = torch.zeros((kp, np_), dtype=torch.bfloat16)
        padded[:din, :dout] = dense
        assert torch.equal(frag, padded[torch.from_numpy(row),
                                        torch.from_numpy(col)])
        # every entry of the weight appears once, the rest is padding
        back = torch.zeros((kp, np_), dtype=torch.bfloat16)
        back[torch.from_numpy(row), torch.from_numpy(col)] = frag
        assert torch.equal(back[:din, :dout], dense)
        assert not back[din:].any() and not back[:, dout:].any()


@pytest.mark.parametrize("site", ["caltech", "jpl"])
@pytest.mark.parametrize("project", [True, False])
def test_ev_segment_ref_counts_every_matvec(site, project):
    """The plain version runs every FISTA iteration of every step (the
    kernel stops a step's projection at its fixed point, with the same
    result) and adds its mat-vecs with C to the caller's count: two per
    iteration, the final C' y and the reward's C p; only the reward's
    without the projection."""
    tenv, tp = tev.make_env(site=site, project_action=project, device="cpu")
    days = torch.tensor([0, 3, 5])
    run = torch.zeros((), dtype=torch.long)
    K.ev_segment(tp, days, 4, seed=1, matvecs=run)
    K.ev_segment(tp, days, 4, seed=2, matvecs=run)
    per_step = 2 * int(tp.proj.iters) + 2 if project else 1
    assert int(run) == 2 * 3 * 4 * per_step


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_ev_segment_ref_admm_matches_jax(site):
    """ev_segment's plain version with the ADMM operator == the JAX Pallas
    kernel's ADMM branch (fused_rollout in interpret mode) on the same
    days and actions, as tests/test_ops_pallas.py:64-103 holds that kernel
    (12 iterations, 128 envs, 12 steps, rtol 2e-4 / atol 2e-5)."""
    jenv, jp = jev.make_env(site=site, proj_method="admm", proj_iters=12)
    tenv, tp = tev.make_env(site=site, proj_method="admm", proj_iters=12,
                            device="cpu")
    n, batch, steps = tp.n_stations, 128, 12
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(8)
    actions = rng.uniform(0, 1, (steps, batch, n)).astype(np.float32)
    fused = jenv.fused_rollout(jp, key, batch, steps,
                               actions=jnp.asarray(actions), w=128,
                               interpret=True)
    days = _jax_days(key, jp, batch)
    out = tenv.fused_rollout(tp, batch, steps, days=torch.tensor(days),
                             actions=torch.from_numpy(actions))
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(fused.reward),
                               **tol)
    for k in ("profit", "carbon_cost", "excess_charge"):
        np.testing.assert_allclose(out.info[k].numpy(),
                                   np.asarray(fused.info[k]), **tol,
                                   err_msg=k)


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_ev_segment_ref_admm_counts_every_matvec(site):
    """With the ADMM operator the plain version counts C x at the start
    and C' y and C x in each of its iterations, and the reward's C p."""
    tenv, tp = tev.make_env(site=site, proj_method="admm", proj_iters=5,
                            device="cpu")
    run = torch.zeros((), dtype=torch.long)
    K.ev_segment(tp, torch.tensor([1, 2]), 3, seed=4, matvecs=run)
    assert int(run) == 2 * 3 * (1 + 2 * 5 + 1)
