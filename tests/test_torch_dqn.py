"""The port's double-DQN learner (sustaingym_tpu_torch.parallel.dqn)
against the JAX package's parallel.dqn: the Q network after from_jax, the
Huber loss, and one whole train step from the same carry on the draws the
JAX train step makes (its exploration draws and mask, its ring slots),
rebuilt from its key tree, on the toy envs of test_torch_sac.py (Discrete
with start 2, uniform MultiDiscrete branching heads, the agent axis, and
plain-max targets); then the JAX tests' behaviours and the CLI.

Tolerances: those of test_torch_sac.py (weights rtol 1e-4 / atol 1e-5);
the ring's int64 actions equal the JAX ring's int32 ones.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sustaingym_tpu.parallel import dqn as jdqn
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import MultiDiscrete, flatten
from sustaingym_tpu_torch.parallel import (DQNConfig, from_jax,
                                           load_jax_carry,
                                           make_dqn_train_step, to_jax)
from sustaingym_tpu_torch.parallel import dqn as tdqn

from .test_torch_sac import (CPU, TorchToy, act_dim_of, compare_step, slots,
                             toy_carries)

BINS = {"discrete": 3, "multi": 4, "agents_multi": 3}


def test_qnet_matches_jax_and_round_trips():
    """qnet_apply after from_jax equals the JAX function (rtol 1e-5 / atol
    1e-5), (..., act_dim, n_bins); to_jax(from_jax(tree)) is exact."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.1, np.shape(x))).astype(
            np.float32),
        jdqn.init_qnet(jax.random.PRNGKey(0), 9, 3, 4, 16))
    obs = rng.normal(0, 1, (5, 2, 9)).astype(np.float32)
    qnet = from_jax(tree, device="cpu")
    assert isinstance(qnet, tdqn.QNet)
    jq = jdqn.qnet_apply(tree, jnp.asarray(obs), 3, 4)
    tq = tdqn.qnet_apply(qnet, torch.from_numpy(obs), 3, 4)
    assert tq.shape == (5, 2, 3, 4)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(to_jax(qnet))):
        np.testing.assert_array_equal(a, b)


def test_huber_loss_matches_optax():
    e = np.linspace(-3, 3, 61).astype(np.float32)
    t = np.full_like(e, 0.25)
    np.testing.assert_allclose(
        tdqn.huber_loss(torch.from_numpy(e), torch.from_numpy(t)).numpy(),
        np.asarray(optax.huber_loss(jnp.asarray(e), jnp.asarray(t))),
        rtol=1e-6, atol=1e-7)


def dqn_draws(key, cfg, shape, n_bins, written, it):
    """The draws of jdqn's train_step(carry, key) at ``iter`` ``it``, in
    the port's order: each rollout step's random bins and exploration mask
    (JAX's uniform(k_mask) < epsilon(iter)) of the greedy action's
    ``shape``; each update's ring slots."""
    frac = jnp.clip(jnp.asarray(it, jnp.int32).astype(jnp.float32)
                    / cfg.eps_decay_iters, 0, 1)
    eps = cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)
    k_roll, k_upd = jax.random.split(key)
    rollout = []
    for kt in jax.random.split(k_roll, cfg.rollout_len):
        _, k_expl, k_mask, _ = jax.random.split(kt, 4)
        rollout.append([
            np.asarray(jax.random.randint(k_expl, shape, 0, n_bins,
                                          jnp.int32)),
            np.asarray(jax.random.uniform(k_mask, shape) < eps)])
    updates = [[slots(ku, cfg, written + cfg.rollout_len)]
               for ku in jax.random.split(k_upd, cfg.updates)]
    return {"rollout": rollout, "updates": updates}


DQN_CASES = {
    "Discrete start 2": ("discrete", dict(capacity=8), 5),
    "branching heads": ("multi", dict(capacity=6, per_env_sample=True), 5),
    "agent axis": ("agents_multi", dict(capacity=8), 2),
    "plain max": ("discrete", dict(capacity=8, double=False), 3),
}


@pytest.mark.parametrize("case", list(DQN_CASES))
def test_dqn_train_step_matches_jax(case):
    """One train step from the same carry (iter 3 of a 6-step epsilon
    decay: epsilon 0.525, both branches taken) on JAX's draws: the qnet,
    its target, the ring (int actions equal), written, the carried obs and
    the metrics."""
    kind, extra, written = DQN_CASES[case]
    kw = dict(num_envs=6, rollout_len=4, batch_per_env=3, updates=3,
              hidden=16, lr=1e-3, eps_decay_iters=6, reward_scale=0.5,
              **extra)
    jcfg, tcfg = jdqn.DQNConfig(**kw), DQNConfig(**kw)
    _, jstep, jcarry, tstep, carry = toy_carries(
        kind, jdqn.make_dqn_train_step, make_dqn_train_step, jcfg, tcfg,
        written, act_int_bins=BINS[kind])
    jcarry["iter"] = jnp.asarray(3, jnp.int32)
    carry["iter"].fill_(3)
    key = jax.random.PRNGKey(11)
    lead = (6, 3) if kind.startswith("agents") else (6,)
    draws = dqn_draws(key, jcfg, lead + (act_dim_of(kind),), BINS[kind],
                      written, 3)
    mask = np.concatenate([r[1].ravel() for r in draws["rollout"]])
    assert 0 < mask.mean() < 1
    jcarry, jm = jax.jit(jstep)(jcarry, key)
    carry, m = tstep(carry, torch.Generator().manual_seed(0), draws=draws)
    compare_step(jcarry, jm, carry, m, ("qnet", "target"))
    assert int(carry["iter"]) == 4
    assert carry["buffer"]["act"].dtype == torch.long


def test_dqn_actor_fn_adds_the_discrete_start():
    """The greedy action of Discrete(3, start=2) is the argmax plus 2;
    of a MultiDiscrete, each head's argmax."""
    for kind, offset in (("discrete", 2), ("multi", 0)):
        init_state, step = make_dqn_train_step(TorchToy(kind), CPU,
                                               DQNConfig(num_envs=4,
                                                         hidden=8))
        carry = init_state(torch.Generator().manual_seed(0))
        obs = torch.randn(4, 5)
        q = tdqn.qnet_apply(carry["qnet"], obs, act_dim_of(kind),
                            BINS[kind])
        want = torch.argmax(q, -1)
        want = want[..., 0] + offset if kind == "discrete" else want
        assert torch.equal(step.actor_fn(carry["qnet"], obs), want)
        assert step.actor_key == "qnet"


def test_dqn_learns_discrete_market():
    """tests/test_dqn.py::test_dqn_learns_discrete_market at its
    configuration and on its own data: the JAX test's initial networks and
    days (its init key) and the draws of its 12 train-step keys, rebuilt
    from the key tree, drive the port's trainer; the greedy Q-action at a
    fresh battery's first obs must be 'discharge' (2), as the JAX test
    asserts, and epsilon at its 0.05 floor.

    The JAX test's draws, not the port's generator: at this size the
    outcome is decided by the draws. Over seeds 0-11 'discharge' came out
    greedy for 8 of the JAX package's seeds, and for 15 of 36 of the
    port's own generator seeds; on the JAX draws of seeds 0-3 the port's
    Q-values track the JAX package's (within 0.04)."""
    from sustaingym_tpu.envs import electricitymarket as jem
    from sustaingym_tpu_torch.envs import electricitymarket as em
    kw = dict(month="2021-05", horizon=2, lp_iters=40, lp_warm_iters=20,
              discrete=True)
    cfg_kw = dict(num_envs=16, rollout_len=16, capacity=256,
                  batch_per_env=8, updates=8, hidden=32, lr=1e-3,
                  eps_decay_iters=6, reward_scale=1e-2)
    jenv, jparams = jem.make_env(**kw)
    jcfg = jdqn.DQNConfig(**cfg_kw)
    jinit, _ = jdqn.make_dqn_train_step(jenv, jparams, jcfg)
    jcarry = jinit(jax.random.PRNGKey(0))
    env, params = em.make_env(device="cpu", **kw)
    init_state, train_step = make_dqn_train_step(env, params,
                                                 DQNConfig(**cfg_kw))
    carry = load_jax_carry(jcarry, init_state(torch.Generator()))
    space = env.observation_space(params)
    days = torch.as_tensor(np.asarray(jcarry["env_states"].day)).long()
    carry["env_states"], ts = env.reset_at_day(params, days)
    carry["obs"] = flatten(space, ts.obs, batch_dims=1)
    _, ts0 = env.reset_at_day(params, torch.tensor([0]))
    obs0 = flatten(space, ts0.obs, batch_dims=1)
    for i in range(12):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        draws = dqn_draws(key, jcfg, (16, 1), 3, 16 * i, i)
        carry, metrics = train_step(carry, torch.Generator(), draws=draws)
    assert np.isfinite(float(metrics["q_loss"]))
    q = tdqn.qnet_apply(carry["qnet"], obs0, 1, 3)[0, 0]
    assert int(torch.argmax(q)) == 2, q
    assert float(metrics["epsilon"]) == pytest.approx(0.05)


def test_dqn_discrete_ma_ev_runs_and_is_finite():
    """tests/test_dqn.py::test_dqn_discrete_ma_ev_runs_and_is_finite:
    branching heads over the agent axis of discrete MA-EV; the ring's act
    (capacity, B, n_agents, 1); finite metrics."""
    env, params = make("evcharging-multiagent", discrete_bins=5,
                       project_action=False, device="cpu")
    cfg = DQNConfig(num_envs=4, rollout_len=4, capacity=32, batch_per_env=2,
                    updates=2, hidden=32)
    init_state, train_step = make_dqn_train_step(env, params, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    n_agents = params.base.n_stations
    assert carry["buffer"]["act"].shape[:3] == (32, 4, n_agents)
    assert train_step.n_agents == n_agents
    carry, metrics = train_step(carry, gen)
    assert np.isfinite(float(metrics["q_loss"]))
    assert np.isfinite(float(metrics["mean_reward"]))


def test_dqn_gates():
    """A Box is refused (naming Discrete); non-uniform bins are refused;
    MA cogen's per-agent policies with the JAX message."""
    env, p = make("electricitymarket", device="cpu", horizon=2, lp_iters=20,
                  lp_warm_iters=10)
    with pytest.raises(ValueError, match="Discrete"):
        make_dqn_train_step(env, p, DQNConfig())
    toy = TorchToy("multi")
    toy.action_space = lambda params: MultiDiscrete([3, 4])
    with pytest.raises(ValueError, match="uniform bins"):
        make_dqn_train_step(toy, CPU, DQNConfig())
    env, p = make("cogen-multiagent", device="cpu")
    with pytest.raises(ValueError, match="only supported by the PPO"):
        make_dqn_train_step(env, p, DQNConfig())


def test_dqn_train_cli_runs_evaluates_and_resumes(tmp_path):
    """--algo dqn on the discrete market: train_results.csv with epsilon
    and q_loss, eval_results.csv and best_model; the checkpoint holds
    iter; a resume takes the next iteration; the checkpoint of another
    algorithm's carry is refused."""
    from sustaingym_tpu_torch import train
    log = tmp_path / "run"
    args = ["--env", "electricitymarket", "--algo", "dqn", "--device", "cpu",
            "--num-envs", "4", "--rollout-len", "4", "--hidden", "16",
            "--iterations", "2", "--save-every", "1", "--eval-every", "1",
            "--eval-episodes", "2", "--log-dir", str(log), "--env-kwargs",
            '{"discrete": true, "horizon": 2, "lp_iters": 20, '
            '"lp_warm_iters": 10}']
    train.main(args)
    rows = (log / "train_results.csv").read_text().splitlines()
    assert len(rows) == 3 and {"epsilon", "q_loss"} <= set(
        rows[0].split(","))
    assert len((log / "eval_results.csv").read_text().splitlines()) == 3
    assert os.listdir(log / "best_model")
    ckpt = torch.load(log / "checkpoints" / "step_2.pt", weights_only=True)
    assert int(ckpt["carry"]["iter"][0]) == 2
    train.main(args + ["--restore", str(log / "checkpoints"),
                       "--iterations", "1"])
    rows = (log / "train_results.csv").read_text().splitlines()
    assert rows[-1].split(",")[rows[0].split(",").index("iteration")] == "2"
    other = ["a2c" if a == "dqn" else a for a in args]
    other[other.index("--log-dir") + 1] = str(tmp_path / "other")
    with pytest.raises(SystemExit, match="does not match"):
        train.main(other + ["--restore", str(log / "checkpoints")])
