"""PyTorch port of ElectricityMarketEnv (sustaingym_tpu_torch.envs.
electricitymarket), its lockstep batch_unroll, and PPO's episodic path on
it and on DataCenterEnv, against the JAX package on the same network,
packed MOER, synthesized load, days and prescribed bids (made with numpy
from a seed).

Tolerances: static arrays bit-equal; stepped rewards, info and obs rtol
2e-4 / atol 2e-3, the JAX package's own bound for its fast path against
its generic path (tests/test_electricitymarket.py:394-402): float32 sums
of the PDHG products in another order, carried through the warm starts;
the port's own paths against each other bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.core import flatten as jflatten
from sustaingym_tpu.envs import electricitymarket as jem
from sustaingym_tpu.envs.electricitymarket import env as jem_env
from sustaingym_tpu.envs.electricitymarket import network as jnet
from sustaingym_tpu.parallel import ppo as jppo
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import (Discrete, batch_rollout, flatdim,
                                       flatten, random_policy, tree_map)
from sustaingym_tpu_torch.envs import electricitymarket as tem
from sustaingym_tpu_torch.envs.electricitymarket import env as tem_env
from sustaingym_tpu_torch.envs.electricitymarket import network as tnet
from sustaingym_tpu_torch.ops.cuda import lp_solve as K9
from sustaingym_tpu_torch.parallel import PPOConfig, from_jax, make_train_step

STEP = dict(rtol=2e-4, atol=2e-3)
SMALL = dict(lp_iters=30, lp_warm_iters=10)   # small budgets: CPU speed


@pytest.fixture(scope="module")
def both():
    return (jem.make_env(**SMALL), tem.make_env(device="cpu", **SMALL))


def test_network_loads_and_permutations_match_jax(both):
    (_, jp), (_, tp) = both
    jn, tn = jnet.build_network(), tnet.build_network()
    for field in jn._fields:
        np.testing.assert_array_equal(getattr(tn, field), getattr(jn, field),
                                      err_msg=field)
    jm, tm = jnet.build_sced_matrices(jn, 4), tnet.build_sced_matrices(tn, 4)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    assert (tp.op.n, tp.op.me, tp.op.ms) == (140, 4, 156)
    for name in ("ub", "gen_cost_tiled", "line_rating", "load_sf", "load",
                 "moer", "warm_perm_x", "warm_perm_y", "warm_perm_z"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for name in ("n_gen", "n_lines", "horizon", "n_days", "ic", "id",
                 "lp_warm_iters", "intermediate_rewards", "discrete"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.op.iters == jp.op.iters == 30
    np.testing.assert_array_equal(tem_env._synthesize_load(3, 5),
                                  jem_env._synthesize_load(3, 5))
    # lp_bf16 resolves per device: bf16 on the card, float32 on the CPU
    assert tp.op.matmul_dtype is None and not tem.uses_solve_kernel(tp)


def _bids(rng, *shape):
    return rng.uniform(0, 120, shape + (8,)).astype(np.float32)


def test_step_matches_jax_over_a_prefix(both):
    """48 steps (a cold solve, then warm-started ones) of the port's
    batched step against the JAX vmapped step on the same bids."""
    (jenv, jp), (tenv, tp) = both
    rng = np.random.default_rng(0)
    B, T = 3, 48
    days = rng.integers(0, tp.n_days, B)
    bids = _bids(rng, T, B)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0, None)))
    jst, jts = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    tst, tts = tenv.reset_at_day(tp, torch.from_numpy(days))
    for t in range(T):
        jst, jts = vstep(jp, jst, jnp.asarray(bids[t]), jax.random.PRNGKey(0))
        tst, tts = tenv.step(tp, tst, torch.from_numpy(bids[t]))
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                                   **STEP, err_msg=f"reward at {t}")
        for k in jts.info:
            np.testing.assert_allclose(tts.info[k].numpy(),
                                       np.asarray(jts.info[k]), **STEP,
                                       err_msg=f"{k} at {t}")
        for k in jts.obs:
            np.testing.assert_allclose(tts.obs[k].numpy(),
                                       np.asarray(jts.obs[k]), **STEP,
                                       err_msg=f"obs {k} at {t}")
    np.testing.assert_allclose(tst.warm_x.numpy(), np.asarray(jst.warm_x),
                               **STEP)


def test_observation_flattening_matches_jax(both):
    """The flat obs is 1 + 1 + 8 + 1 + 1 + 1 + 4 + 1 + 4 = 22 wide, in the
    JAX package's DictSpace order."""
    (jenv, jp), (tenv, tp) = both
    space = tenv.observation_space(tp)
    assert flatdim(space) == 22
    assert list(space.spaces) == list(jenv.observation_space(jp).spaces)
    days = np.array([0, 7, 30])
    _, jts = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.asarray(days, jnp.int32))
    st, ts = tenv.reset_at_day(tp, torch.from_numpy(days))
    jflat = np.asarray(jax.vmap(lambda o: jflatten(
        jenv.observation_space(jp), o))(jts.obs))
    np.testing.assert_allclose(flatten(space, ts.obs, 1).numpy(), jflat,
                               rtol=1e-6, atol=1e-6)
    _, ts = tenv.step(tp, st, torch.zeros((3, 8)))
    assert torch.equal(ts.obs["prev_load"][:, 0], tp.load[days, 0])


def test_discrete_bids_match_jax():
    """discrete=True: a Discrete(3) action space, one-hot flattening; each
    action's step equals the continuous step on its DISCRETE_BIDS, and the
    JAX package's discrete step."""
    kw = dict(horizon=2, lp_iters=40, lp_warm_iters=10)
    jenv, jp = jem.make_env(discrete=True, **kw)
    tenv, tp = tem.make_env(discrete=True, device="cpu", **kw)
    _, tpc = tem.make_env(device="cpu", **kw)
    space = tenv.action_space(tp)
    assert isinstance(space, Discrete) and space.n == 3
    assert flatten(space, torch.tensor([2, 0]), 1).tolist() == [
        [0, 0, 1], [1, 0, 0]]
    a = space.sample_batch(torch.Generator().manual_seed(0), 600)
    assert set(a.tolist()) == {0, 1, 2}
    assert tem.DISCRETE_BIDS == jem_env.DISCRETE_BIDS
    acts = torch.tensor([0, 1, 2])
    st, _ = tenv.reset_at_day(tp, torch.zeros(3, dtype=torch.long))
    st_d, ts_d = tenv.step(tp, st, acts)
    bids = torch.tensor(tem.DISCRETE_BIDS).repeat_interleave(2, dim=-1)
    st_c, ts_c = tenv.step(tpc, st, bids)
    assert torch.equal(ts_d.reward, ts_c.reward)
    assert torch.equal(st_d.energy, st_c.energy)
    jst, _ = jax.vmap(jenv.reset_at_day, in_axes=(None, 0))(
        jp, jnp.zeros(3, jnp.int32))
    jst, jts = jax.vmap(jenv.step, in_axes=(None, 0, 0, None))(
        jp, jst, jnp.asarray(acts.numpy()), jax.random.PRNGKey(0))
    np.testing.assert_allclose(ts_d.reward.numpy(), np.asarray(jts.reward),
                               **STEP)
    delta = (st_d.energy - st_d.energy0).tolist()
    assert delta[0] > 1e-3 and abs(delta[1]) < 0.5 and delta[2] < -1e-3


@pytest.mark.parametrize("bf16", [False, True])
def test_batch_unroll_matches_generic(bf16):
    """The lockstep batch_unroll and the generic env.step loop with
    autoreset across the episode boundary (288 + 3 steps): the same draws
    from the generator, the same budgets (cold at each episode's first
    step), so the same trajectory, bit for bit. With bf16 products the
    unroll solves through pdhg_solve_paired (on the CPU its plain
    version)."""
    env, p = tem.make_env(lp_bf16=bf16, device="cpu", **SMALL)
    assert tem.uses_solve_kernel(p) == bf16
    B, T = 2, 288 + 3

    def roll(fast):
        g = torch.Generator().manual_seed(11)
        return batch_rollout(env, p, random_policy(env, p, B), None, g, B, T,
                             fast=fast)

    launches = K9.pdhg_solve_paired.launches
    fast, slow = roll(True), roll(False)
    assert K9.pdhg_solve_paired.launches == launches     # CPU: plain
    tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
             fast, slow)
    assert fast.terminated[287].all() and not fast.terminated[:287].any()
    assert fast.obs["time"][287].eq(0).all()
    assert np.isfinite(fast.reward.numpy()).all()


def test_generic_step_through_the_kernel_wrapper():
    """With the packed operator (``params.kops``, which ``make_params``
    fills on the card), the generic step's solve is one
    ``pdhg_solve_paired`` call with the per-env budgets (cold at t = 0,
    warm after) as an int32 tensor. On CPU tensors the wrapper runs its
    plain version, so the step equals the ``solve_lp`` route bit for bit,
    envs at their first and at a later step together; on the CPU
    ``make_params`` leaves ``kops`` empty."""
    from sustaingym_tpu_torch.core import replace
    from sustaingym_tpu_torch.core.graph import tree_leaves
    env, p = tem.make_env(lp_bf16=True, device="cpu", **SMALL)
    assert p.kops is None and tem.uses_solve_kernel(p)
    pk = replace(p, kops=K9.pack_pdhg_operands(p.op))
    rng = np.random.default_rng(8)
    state, _ = env.reset_at_day(p, torch.tensor([0, 4, 9]))
    st_k = state
    for t in range(3):
        acts = torch.from_numpy(_bids(rng, 3))
        if t == 1:   # env 0 restarts: cold and warm budgets in one batch
            fresh, _ = env.reset_at_day(p, torch.tensor([2]))
            state, st_k = (replace(s, **{
                f: torch.cat([getattr(fresh, f), getattr(s, f)[1:]])
                for f in s.__dataclass_fields__}) for s in (state, st_k))
            assert state.t.tolist() == [0, 1, 1]
        calls = K9.pdhg_solve_paired.launches
        state, ts = env.step(p, state, acts)
        st_k, ts_k = env.step(pk, st_k, acts)
        assert K9.pdhg_solve_paired.launches == calls   # CPU: plain version
        for a, b in zip(tree_leaves(state) + tree_leaves(ts),
                        tree_leaves(st_k) + tree_leaves(ts_k)):
            assert torch.equal(a, b)


def _from_jax_policy(obs_dim, act_dim, hidden, seed):
    tree = jppo.init_policy(jax.random.PRNGKey(seed), obs_dim, act_dim,
                            hidden, dtype=jnp.float32)
    return from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree),
                    device="cpu")


@pytest.mark.parametrize("name,kwargs,obs_dim,act_dim", [
    ("datacenter", {}, 27, 1),
    ("electricitymarket", SMALL, 22, 8),
])
def test_episodic_ppo_lr0_exact_ratio(name, kwargs, obs_dim, act_dim):
    """PPO's episodic path (batch_unroll, f32 policy from JAX weights, tanh
    squash to the Box) on each env: with lr=0 every ratio is 1, so pg_loss
    vanishes and the weights stay put; one whole episode per env."""
    env, p = make(name, device="cpu", **kwargs)
    cfg = PPOConfig(num_envs=4, hidden=16, minibatches=2, epochs=1, lr=0.0)
    init_state, train_step = make_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    policy = _from_jax_policy(obs_dim, act_dim, 16, 7)
    carry = {"policy": policy,
             "opt": torch.optim.Adam(policy.parameters(), lr=0.0)}
    w0 = policy.trunk1.weight.detach().clone()
    carry, metrics = train_step(carry, gen)
    m = {k: float(v) for k, v in metrics.items()}
    L = env.episode_steps(p)
    assert abs(m["pg_loss"]) < 1e-5, m
    assert np.isfinite(m["vf_loss"]) and np.isfinite(m["mean_reward"])
    assert m["episode_done_frac"] == pytest.approx(1.0 / L)
    assert torch.equal(carry["policy"].trunk1.weight, w0)


def test_discrete_market_ppo_is_refused():
    """The discrete market (Discrete(3) bids), once refused for want of a
    categorical head, now trains on the episodic path: integer bins drawn
    and re-scored by the categorical head; with lr=0 every ratio is
    exactly 1 (PPO's |pg_loss| < 1e-5) and the weights stay put; A2C runs
    the same rollout with its own policy loss."""
    env, p = make("electricitymarket", discrete=True, device="cpu", **SMALL)
    for algo in ("ppo", "a2c"):
        cfg = PPOConfig(num_envs=4, hidden=16, minibatches=2, epochs=1,
                        lr=0.0, algo=algo)
        init_state, train_step = make_train_step(env, p, cfg)
        gen = torch.Generator().manual_seed(0)
        carry = init_state(gen)
        assert carry["policy"].mu.weight.shape == (3, 16)
        w0 = carry["policy"].trunk1.weight.detach().clone()
        out = train_step.rollout(carry["policy"], gen)
        assert out["u"].shape == (288, 4, 1) and out["u"].dtype == torch.long
        assert int(out["u"].min()) >= 0 and int(out["u"].max()) <= 2
        carry, metrics = train_step(carry, gen)
        m = {k: float(v) for k, v in metrics.items()}
        if algo == "ppo":
            assert abs(m["pg_loss"]) < 1e-5, m
        assert all(np.isfinite(v) for v in m.values()), m
        assert 0 < m["entropy"] <= np.log(3) + 1e-6
        assert torch.equal(carry["policy"].trunk1.weight, w0)


def _present_batch_unroll(env, p, policy, batch, num_steps, generator):
    """ElectricityMarketEnv.batch_unroll as one loop over every step, as it
    was before its step loop became the part a CUDA graph captures."""
    from sustaingym_tpu_torch.core import replace, tree_stack
    from sustaingym_tpu_torch.ops import lp
    op, L, ms = p.op, tem_env.T_STEPS, p.op.ms
    lb = torch.zeros_like(p.ub)
    kops = K9.pack_pdhg_operands(op) if tem.uses_solve_kernel(p) else None

    def solve(c, b, h, init, iters):
        if kops is None:
            return lp.solve_lp(op, c, b, h, lb, p.ub, init=init, iters=iters)
        x, y, zp, zm = K9.pdhg_solve_paired(
            kops, c, b, h[:, :ms].contiguous(), h[:, ms:].contiguous(),
            p.ub, init.x, init.y, init.z[:, :ms].contiguous(),
            init.z[:, ms:].contiguous(), iters)
        return lp.LPSolution(x=x, y=y, z=torch.cat([zp, zm], -1))

    state, ts = env._episode_start(p, 0, batch, generator, None)
    obs, traj = ts.obs, []
    for i in range(num_steps):
        t_in_ep = i % L
        actions = env._prep_action(p, policy(None, obs, generator))
        c, b, h, init, load0 = env._sced_problem(p, state, actions)
        sol = solve(c, b, h, init,
                    op.iters if t_in_ep == 0 else p.lp_warm_iters)
        state, ts = env._apply_cleared(p, state, actions,
                                       env._cleared(p, sol, load0))
        if t_in_ep == L - 1:
            state, ts_r = env._episode_start(p, i // L + 1, batch, generator,
                                             None)
            ts = replace(ts, obs=ts_r.obs)
        obs = ts.obs
        traj.append(ts)
    return tree_stack(traj)


@pytest.mark.parametrize("bf16,discrete", [(False, False), (True, False),
                                           (True, True)])
def test_split_batch_unroll_matches_the_present_loop(bf16, discrete):
    """batch_unroll split into an eager episode start and a step loop
    (_episode_steps, which a CUDA graph captures on the card, solve
    launches included), called directly and through a CPU Graphs, against
    the loop it replaces: bit for bit across the episode boundary, through
    solve_lp and through pdhg_solve_paired's plain version, with Box and
    with Discrete(3) bids."""
    from sustaingym_tpu_torch.core.graph import Graphs
    env, p = tem.make_env(lp_bf16=bf16, discrete=discrete, device="cpu",
                          **SMALL)
    B, T = 2, 288 + 3
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


@pytest.mark.parametrize("name", ["datacenter", "electricitymarket"])
def test_train_cli_cpu(name, tmp_path):
    from sustaingym_tpu_torch import train
    args = ["--env", name, "--device", "cpu", "--num-envs", "2", "--hidden",
            "8", "--minibatches", "2", "--epochs", "1", "--iterations", "1",
            "--log-dir", str(tmp_path)]
    if name == "electricitymarket":
        args += ["--env-kwargs", '{"lp_iters": 5, "lp_warm_iters": 2}']
    train.main(args)
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert len(rows) == 2 and "pg_loss" in rows[0]
