"""PyTorch port of DataCenterEnv (sustaingym_tpu_torch.envs.datacenter),
its rollout paths and the plain version of the datacenter episode kernel,
against the JAX package on the same packed data, months and prescribed
VCCs (made with numpy from a seed).

Tolerances: rtol / atol 1e-6 (both packages run the same float32
operations; XLA may contract a multiply-add where PyTorch rounds twice);
the port's own paths against each other are bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.envs import datacenter as jdc
from sustaingym_tpu.envs.datacenter import env as jdc_env
from sustaingym_tpu.ops.pallas.dc_rollout import fused_dc_segment
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import batch_rollout, random_policy, tree_map
from sustaingym_tpu_torch.envs import datacenter as tdc
from sustaingym_tpu_torch.envs.datacenter import env as tdc_env
from sustaingym_tpu_torch.ops.cuda import dc_rollout as K8
from sustaingym_tpu_torch.ops.cuda import exog_gather as KA

TOL = dict(rtol=1e-6, atol=1e-6)
L = tdc.EPISODE_LEN


@pytest.fixture(scope="module")
def both():
    return jdc.make_env(), tdc.make_env(device="cpu")


def test_make_params_matches_jax(both):
    (_, jp), (_, tp) = both
    assert tp.n_months == jp.n_months == 28
    assert tp.table.shape == (28, 696, 2) and tp.table.is_contiguous()
    np.testing.assert_array_equal(tp.table[:, :L, 0].numpy(),
                                  np.asarray(jp.arrivals))
    assert not tp.table[:, L:, 0].any()
    np.testing.assert_array_equal(tp.table[..., 1].numpy(), np.asarray(jp.moer))
    np.testing.assert_array_equal(tdc_env._synthesize_arrivals(3),
                                  jdc_env._synthesize_arrivals(3))
    assert tdc_env._months() == jdc_env._months()


def _jax_reset(jenv, jp, months):
    return jax.vmap(jenv.reset_at_month, in_axes=(None, 0))(
        jp, jnp.asarray(months, jnp.int32))


def test_step_matches_jax_across_the_episode_boundary(both):
    """The port's batched step against the JAX vmapped step over a whole
    672-hour episode and 4 hours into the next (reset spliced at the
    boundary), on VCCs outside [0, 1] too (both clip)."""
    (jenv, jp), (tenv, tp) = both
    rng = np.random.default_rng(0)
    B, T = 4, L + 4
    months = rng.integers(0, 28, (2, B))
    acts = rng.uniform(-0.2, 1.2, (T, B)).astype(np.float32)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    jst, jts = _jax_reset(jenv, jp, months[0])
    tst, tts = tenv.reset_at_month(tp, torch.from_numpy(months[0]))
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), **TOL)
    for t in range(T):
        jst, jts = vstep(jp, jst, jnp.asarray(acts[t][:, None]),
                         jax.random.PRNGKey(0))
        tst, tts = tenv.step(tp, tst, torch.from_numpy(acts[t][:, None]))
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                                   **TOL, err_msg=f"reward at {t}")
        np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs),
                                   **TOL, err_msg=f"obs at {t}")
        for k in jts.info:
            np.testing.assert_allclose(tts.info[k].numpy(),
                                       np.asarray(jts.info[k]), **TOL,
                                       err_msg=f"{k} at {t}")
        assert tts.terminated.tolist() == np.asarray(jts.terminated).tolist()
        if t == L - 1:
            assert bool(tts.terminated.all())
            jst, _ = _jax_reset(jenv, jp, months[1])
            tst, _ = tenv.reset_at_month(tp, torch.from_numpy(months[1]))


@pytest.mark.parametrize("steps", [30, L + 8])
def test_batch_unroll_matches_generic(steps):
    """The lockstep batch_unroll (one month-row gather per episode) and
    the generic env.step loop with autoreset draw from the generator in
    the same order, so they agree bit for bit, within an episode and
    across its boundary."""
    env, p = make("datacenter", device="cpu")
    B = 6

    def roll(fast):
        g = torch.Generator().manual_seed(11)
        return batch_rollout(env, p, random_policy(env, p, B), None, g, B,
                             steps, fast=fast)

    launches = KA.episode_slice_gather.launches
    fast, slow = roll(True), roll(False)
    assert KA.episode_slice_gather.launches == launches   # CPU: plain
    tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
             fast, slow)
    assert fast.obs.shape == (steps, B, 27)
    assert bool(fast.terminated[L - 1:L].all()) \
        and not fast.terminated[:L - 1].any()


def test_dc_segment_ref_matches_jax_kernel(both):
    """The plain version of the port's kernel against the JAX package's
    Pallas kernel (interpret mode) on the same month rows and VCCs, laid
    out as the JAX fused_rollout lays them out."""
    (_, jp), (_, tp) = both
    rng = np.random.default_rng(1)
    il, w, T = 2, 128, 30
    B = il * w
    months = rng.integers(0, 28, B)
    acts = rng.uniform(-0.1, 1.1, (T, B)).astype(np.float32)
    table = np.asarray(tp.table)
    wx = np.transpose(table[months, :T].reshape(1, il, w, T, 2),
                      (0, 1, 3, 4, 2))
    ak = np.transpose(acts.reshape(T, 1, il, w, 1), (1, 2, 0, 4, 3))
    out = np.asarray(fused_dc_segment(
        jnp.asarray(wx), jnp.asarray(ak), jnp.zeros((), jnp.int32), T, il, w,
        use_rng=False, interpret=True))                 # (1, il, T, 8, w)
    jrows = np.transpose(out[0, :, :, :6], (2, 1, 0, 3)).reshape(6, T, B)
    trows = K8.dc_segment(tp, torch.from_numpy(months), T,
                          actions=torch.from_numpy(acts))
    assert trows.shape == (6, T, B)
    np.testing.assert_allclose(trows.numpy(), jrows, **TOL)
    np.testing.assert_array_equal(trows[0].numpy(), np.clip(acts, 0, 1))


def test_dc_segment_ref_is_the_env_step(both):
    """Rows of the plain version equal the env's step from a reset, and
    its RNG mode draws U[0, 1)."""
    (_, _), (tenv, tp) = both
    rng = np.random.default_rng(2)
    B, T = 16, 50
    months = torch.from_numpy(rng.integers(0, 28, B))
    acts = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32))
    rows = K8.dc_segment(tp, months, T, actions=acts)
    st, _ = tenv.reset_at_month(tp, months)
    for t in range(T):
        st, ts = tenv.step(tp, st, acts[t])
        assert torch.equal(rows[1, t], ts.info["executed"])
        assert torch.equal(rows[2, t], ts.info["queue"])
        assert torch.equal(rows[3, t], ts.reward)
        assert torch.equal(rows[4, t], ts.info["carbon_cost"])
        assert torch.equal(rows[5, t], ts.info["delay_penalty"])
    a = K8.dc_segment(tp, months, T, seed=4)[0]
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.05


def test_fused_rollout_matches_batch_unroll_and_splices(both):
    """fused_rollout on prescribed VCCs and months (CPU: the plain versions
    of the gather and the episode kernel) equals batch_unroll on the same
    inputs across the episode boundary, where the last obs is the next
    episode's reset obs; RNG mode is reproducible from the generator."""
    (_, _), (tenv, tp) = both
    rng = np.random.default_rng(3)
    B, T = 5, L + 3
    months = rng.integers(0, 28, (2, B))
    acts = torch.from_numpy(rng.uniform(0, 1, (T, B, 1)).astype(np.float32))
    counts = (KA.episode_slice_gather.launches, K8.dc_segment.launches)
    fused = tenv.fused_rollout(tp, B, T, actions=acts, months=months)
    assert (KA.episode_slice_gather.launches,
            K8.dc_segment.launches) == counts    # CPU: plain versions
    step = iter(range(T))
    unroll = tenv.batch_unroll(tp, lambda _, obs, g: acts[next(step)], None,
                               B, T, months=months)
    tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
             fused, unroll)
    assert fused.obs.shape == (T, B, 27) and fused.reward.shape == (T, B)
    assert fused.terminated[L - 1].all() and not fused.terminated[L:].any()
    _, ts_r = tenv.reset_at_month(tp, torch.from_numpy(months[1]))
    assert torch.equal(fused.obs[L - 1], ts_r.obs)
    r1 = tenv.fused_rollout(tp, 8, 30, generator=torch.Generator().manual_seed(5))
    r2 = tenv.fused_rollout(tp, 8, 30, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(r1.reward.numpy(), r2.reward.numpy())
    assert np.isfinite(r1.reward.numpy()).all()


def test_spaces_match_jax(both):
    (jenv, jp), (tenv, tp) = both
    for name in ("observation_space", "action_space"):
        js, ts = getattr(jenv, name)(jp), getattr(tenv, name)(tp)
        assert js.shape == ts.shape
        np.testing.assert_array_equal(js.low, ts.low)
        np.testing.assert_array_equal(js.high, ts.high)
    assert tenv.episode_steps(tp) == jenv.episode_steps(jp) == L


def _present_batch_unroll(env, p, policy, batch, num_steps, generator):
    """DataCenterEnv.batch_unroll as one loop over every step, as it was
    before its step loop became the part a CUDA graph captures."""
    from sustaingym_tpu_torch.core import replace, tree_stack
    L, rows = tdc_env.EPISODE_LEN, p.table.shape[1]
    flat = p.table.reshape(-1, 2)
    state, ts = env._episode_start(p, 0, batch, generator, None)
    obs, traj = ts.obs, []
    for ep, t0 in enumerate(range(0, num_steps, L)):
        seg = min(L, num_steps - t0)
        block = KA.episode_slice_gather(flat, state.month * rows,
                                        rows).transpose(0, 1)
        for t in range(seg):
            actions = policy(None, obs, generator)
            state, ts = env._step_exog(
                p, state, actions, block[t, :, 0], block[t, :, 1],
                block[t + 1:t + 1 + tdc_env.FORECAST_H, :, 1].T)
            obs = ts.obs
            traj.append(ts)
        if seg == L:
            state, ts_r = env._episode_start(p, ep + 1, batch, generator,
                                             None)
            obs = ts_r.obs
            traj[-1] = replace(traj[-1], obs=obs)
    return tree_stack(traj)


def test_split_batch_unroll_matches_the_present_loop():
    """batch_unroll split into an eager episode start and a step loop
    (_episode_steps, which a CUDA graph captures on the card), called
    directly and through a CPU Graphs, against the loop it replaces: bit
    for bit across the episode boundary."""
    from sustaingym_tpu_torch.core.graph import Graphs
    env, p = make("datacenter", device="cpu")
    B, T = 4, L + 5
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
