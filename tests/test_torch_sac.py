"""The port's SAC learner (sustaingym_tpu_torch.parallel.sac) against the
JAX package's parallel.sac: the networks after from_jax, the tanh-Gaussian
sample, and one whole train step from the same carry on the draws that
the JAX train step makes, rebuilt from its key tree; then the JAX tests'
behaviours (ring wrap, targets, gates, the multi-agent smoke, learning)
and the CLI.

The toy envs below are written twice, for JAX and for the port (as
tests/test_ppo.py writes _QuadTrackEnv): a deterministic step that draws
nothing, episodes of ``L`` steps, and five action spaces (a Box with
unequal bounds, Discrete with start 2, a uniform MultiDiscrete, and the
agent-axis Box and MultiDiscrete). test_torch_dqn.py and
test_torch_ddpg.py use them too.

Tolerances of a train step against JAX: weights, targets and log_alpha
rtol 1e-4 / atol 1e-5; the ring's float fields and the carried obs rtol
1e-5 / atol 1e-6, its integer fields and ``written`` equal; metrics rtol
1e-4 / atol 1e-5.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu import core as jcore
from sustaingym_tpu.parallel import sac as jsac
from sustaingym_tpu_torch import core as tcore
from sustaingym_tpu_torch.bench import make_env
from sustaingym_tpu_torch.parallel import (SACConfig, from_jax,
                                           load_jax_carry,
                                           make_sac_train_step, to_jax,
                                           train_sac)
from sustaingym_tpu_torch.parallel import sac as tsac

L, D, A = 3, 5, 3
NETS = dict(rtol=1e-4, atol=1e-5)
RING = dict(rtol=1e-5, atol=1e-6)
CPU = types.SimpleNamespace(device=torch.device("cpu"))


def _space(core, kind):
    if kind == "box":
        return core.Box(np.array([-1.0, 0.0, -2.0]), np.array([1.0, 2.0, 0.5]))
    if kind == "discrete":
        return core.Discrete(3, start=2)
    if kind == "multi":
        return core.MultiDiscrete(np.full(3, 4))
    if kind == "agents_box":
        return core.Box(-1.0, 1.0, (A, 1))
    return core.MultiDiscrete(np.full((A, 1), 3))


def _act_vec(kind, a):
    """The float action ``a`` as the reward reads it: (..., 3), (..., 1)
    or each agent's (..., A, 1)."""
    if kind == "discrete":
        return a[..., None] - 3.0
    if kind == "multi":
        return (a - 1.5) / 1.5
    if kind == "agents_multi":
        return a - 1.0
    return a


def _c0(agents):
    c = np.linspace(-0.5, 0.5, D, dtype=np.float32)
    if agents:
        return c[None] + 0.1 * np.arange(A, dtype=np.float32)[:, None]
    return c


class JaxToy:
    """The deterministic toy env, one env of the JAX package's protocol."""
    name = "toy"

    def __init__(self, kind):
        self.kind = kind
        self.agent_axis = kind.startswith("agents")

    def observation_space(self, params):
        return jcore.Box(-5, 5, (A, D) if self.agent_axis else (D,))

    def action_space(self, params):
        return _space(jcore, self.kind)

    def _ts(self, obs, reward, done):
        return jcore.TimeStep(obs=obs, reward=reward, terminated=done,
                              truncated=jnp.zeros((), bool), info={})

    def reset(self, params, key):
        obs = jnp.asarray(_c0(self.agent_axis))
        reward = jnp.zeros((A,) if self.agent_axis else (), jnp.float32)
        return (obs, jnp.zeros((), jnp.int32)), self._ts(
            obs, reward, jnp.zeros((), bool))

    def step(self, params, state, action, key):
        obs, t = state
        a = _act_vec(self.kind, jnp.asarray(action, jnp.float32))
        tf = (t + 1).astype(jnp.float32) * 0.01
        if self.agent_axis:
            reward = -(a[..., 0] - 0.3 * obs[..., 0]) ** 2
            nxt = 0.8 * obs + 0.2 * jnp.tanh(a) + tf
        else:
            m = a.shape[-1]
            reward = -jnp.sum((a - 0.3 * obs[:m]) ** 2)
            nxt = 0.8 * obs + 0.2 * jnp.tanh(jnp.sum(a)) + tf
        return (nxt, t + 1), self._ts(nxt, reward, t + 1 >= L)


@tcore.dataclass
class ToyState:
    obs: torch.Tensor
    t: torch.Tensor


class TorchToy:
    """The same env batched, in the port's protocol."""
    name = "toy"

    def __init__(self, kind):
        self.kind = kind
        self.agent_axis = kind.startswith("agents")

    def observation_space(self, params):
        return tcore.Box(-5, 5, (A, D) if self.agent_axis else (D,))

    def action_space(self, params):
        return _space(tcore, self.kind)

    def _ts(self, obs, reward, done):
        return tcore.TimeStep(obs=obs, reward=reward, terminated=done,
                              truncated=torch.zeros_like(done), info={})

    def reset(self, params, generator, batch):
        obs = torch.from_numpy(_c0(self.agent_axis)).expand(
            (batch,) + _c0(self.agent_axis).shape).clone()
        reward = torch.zeros((batch, A) if self.agent_axis else (batch,))
        return (ToyState(obs, torch.zeros(batch, dtype=torch.long)),
                self._ts(obs, reward, torch.zeros(batch, dtype=torch.bool)))

    def step(self, params, state, action, generator=None):
        obs, t = state.obs, state.t
        a = _act_vec(self.kind, action.float())
        tf = (t + 1).float() * 0.01
        if self.agent_axis:
            reward = -(a[..., 0] - 0.3 * obs[..., 0]) ** 2
            nxt = 0.8 * obs + 0.2 * torch.tanh(a) + tf[:, None, None]
        else:
            m = a.shape[-1]
            reward = -torch.sum((a - 0.3 * obs[:, :m]) ** 2, -1)
            nxt = (0.8 * obs + 0.2 * torch.tanh(torch.sum(a, -1))[:, None]
                   + tf[:, None])
        return ToyState(nxt, t + 1), self._ts(nxt, reward, t + 1 >= L)


def act_dim_of(kind):
    return {"box": 3, "discrete": 1, "multi": 3}.get(kind, 1)


def toy_carries(kind, jax_factory, port_factory, jcfg, tcfg, written,
                seed=0, act_int_bins=None):
    """(JAX env, JAX train step, JAX carry, port train step, port carry)
    from the same start: the JAX init's networks with every leaf perturbed
    (targets apart from their online networks), float32, envs at random obs and clocks, a
    random ring and ``written``; the port's loaded from them."""
    jenv, tenv = JaxToy(kind), TorchToy(kind)
    jinit, jstep = jax_factory(jenv, None, jcfg)
    jcarry = jinit(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(x):
        # float32 leaves: with jax_enable_x64 (tests/conftest.py) the JAX
        # _dense's float64 scale makes its weights float64
        return jnp.asarray((np.asarray(x) + rng.normal(
            0, 0.1, np.shape(x))).astype(np.float32))

    for name in ("actor", "critics", "targets", "actor_target", "qnet",
                 "target"):
        if name in jcarry:
            jcarry[name] = jax.tree.map(perturb, jcarry[name])
    B, cap = jcfg.num_envs, jcfg.capacity
    lead = (B, A) if kind.startswith("agents") else (B,)
    obs = rng.normal(0, 1, lead + (D,)).astype(np.float32)
    t = rng.integers(0, L, B).astype(np.int32)
    ring = {"obs": rng.normal(0, 1, (cap,) + lead + (D,)).astype(np.float32),
            "reward": rng.normal(0, 1, (cap,) + lead).astype(np.float32),
            "next_obs": rng.normal(0, 1, (cap,) + lead + (D,)).astype(
                np.float32),
            "done": (rng.uniform(size=(cap,) + lead) < 0.3).astype(
                np.float32)}
    adim = act_dim_of(kind)
    if act_int_bins:
        ring["act"] = rng.integers(0, act_int_bins, (cap,) + lead + (adim,)
                                   ).astype(np.int32)
    else:
        ring["act"] = rng.uniform(-0.9, 0.9, (cap,) + lead + (adim,)
                                  ).astype(np.float32)
    jcarry["env_states"] = (jnp.asarray(obs), jnp.asarray(t))
    jcarry["obs"] = jnp.asarray(obs)
    jcarry["buffer"] = {k: jnp.asarray(v) for k, v in ring.items()}
    jcarry["written"] = jnp.asarray(written, jnp.int32)

    tinit, tstep = port_factory(tenv, CPU, tcfg)
    carry = tinit(torch.Generator().manual_seed(seed))
    load_jax_carry(jcarry, carry)
    carry["env_states"] = ToyState(torch.from_numpy(obs.copy()),
                                   torch.from_numpy(t.astype(np.int64)))
    carry["obs"] = torch.from_numpy(obs.copy())
    for k, v in ring.items():
        carry["buffer"][k].copy_(torch.from_numpy(v))
    carry["written"].fill_(written)
    return jenv, jstep, jcarry, tstep, carry


def slots(k, cfg, written_after):
    """The ring slots jax.random.randint draws in sample_transitions."""
    shape = ((cfg.batch_per_env, cfg.num_envs) if cfg.per_env_sample
             else (cfg.batch_per_env,))
    filled = jnp.minimum(jnp.asarray(written_after, jnp.int32), cfg.capacity)
    return np.asarray(jax.random.randint(k, shape, 0, jnp.maximum(filled, 1)))


def batch_lead(cfg, kind):
    lead = (cfg.batch_per_env, cfg.num_envs)
    return lead + (A,) if kind.startswith("agents") else lead


def sac_draws(key, cfg, kind, written):
    """The draws of jsac's train_step(carry, key), in the port's order:
    each rollout step's action normals; each update's slots, next-action
    normals and fresh-action normals."""
    adim = act_dim_of(kind)
    lead = (cfg.num_envs, A) if kind.startswith("agents") else (
        cfg.num_envs,)
    k_roll, k_upd = jax.random.split(key)
    rollout = []
    for kt in jax.random.split(k_roll, cfg.rollout_len):
        k_act, _ = jax.random.split(kt)
        rollout.append([np.asarray(jax.random.normal(
            k_act, lead + (adim,), jnp.float32))])
    bshape = batch_lead(cfg, kind) + (adim,)
    updates = []
    for ku in jax.random.split(k_upd, cfg.updates):
        k_samp, k_next, k_act = jax.random.split(ku, 3)
        updates.append([slots(k_samp, cfg, written + cfg.rollout_len),
                        np.asarray(jax.random.normal(k_next, bshape,
                                                     jnp.float32)),
                        np.asarray(jax.random.normal(k_act, bshape,
                                                     jnp.float32))])
    return {"rollout": rollout, "updates": updates}


def compare_step(jcarry, jm, carry, m, nets):
    """The port's carry and metrics after a train step against JAX's, at
    the module docstring's tolerances."""
    for name in nets:
        jt = jax.tree.leaves(jcarry[name])
        tt = jax.tree.leaves(to_jax(carry[name]))
        assert len(jt) == len(tt)
        for a, b in zip(jt, tt):
            np.testing.assert_allclose(b, np.asarray(a), **NETS, err_msg=name)
    if "log_alpha" in carry:
        np.testing.assert_allclose(float(carry["log_alpha"]),
                                   float(jcarry["log_alpha"]), **NETS)
    assert int(carry["written"]) == int(jcarry["written"])
    for k, v in jcarry["buffer"].items():
        got = carry["buffer"][k].numpy()
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(got, np.asarray(v), **RING, err_msg=k)
    np.testing.assert_allclose(carry["obs"].numpy(), np.asarray(jcarry["obs"]),
                               **RING)
    np.testing.assert_array_equal(carry["env_states"].t.numpy(),
                                  np.asarray(jcarry["env_states"][1]))
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# networks and the tanh-Gaussian sample
# ---------------------------------------------------------------------------

def _jtree(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32) + rng.normal(
        0, 0.1, np.shape(x)).astype(np.float32), tree)


def test_actor_and_critic_match_jax_and_round_trip():
    """After from_jax, actor_apply (mu and the bounded log_std) and
    critic_apply equal the JAX functions (rtol 1e-5 / atol 1e-5);
    to_jax(from_jax(tree)) is the tree exactly, the twin critics as a
    ModuleDict too."""
    actor = _jtree(jsac.init_actor(jax.random.PRNGKey(0), 10, 6, 32), 1)
    critics = {q: _jtree(jsac.init_critic(jax.random.PRNGKey(i), 10, 6, 32),
                         i + 2) for i, q in enumerate(("q1", "q2"))}
    rng = np.random.default_rng(3)
    obs = rng.normal(0, 2, (7, 4, 10)).astype(np.float32)
    act = rng.uniform(-1, 1, (7, 4, 6)).astype(np.float32)
    tactor = from_jax(actor, device="cpu")
    assert isinstance(tactor, tsac.SACActor)
    jmu, jls = jsac.actor_apply(actor, jnp.asarray(obs))
    tmu, tls = tsac.actor_apply(tactor, torch.from_numpy(obs))
    assert float(tls.detach().min()) >= -5.0
    assert float(tls.detach().max()) <= 2.0
    for a, b in ((tmu, jmu), (tls, jls)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    tcrit = from_jax(critics, device="cpu")
    for q in ("q1", "q2"):
        jq = jsac.critic_apply(critics[q], jnp.asarray(obs), jnp.asarray(act))
        tq = tsac.critic_apply(tcrit[q], torch.from_numpy(obs),
                               torch.from_numpy(act))
        assert tq.shape == (7, 4)
        np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                                   rtol=1e-5, atol=1e-5)
    for tree, mod in ((actor, tactor), (critics, tcrit)):
        back = to_jax(mod)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)


def test_sample_tanh_gauss_matches_jax():
    """On the JAX function's own normals (normal(key, mu.shape)), a and
    logp equal jsac._sample_tanh_gauss (rtol 1e-5 / atol 1e-4 on logp, a
    sum of 6 terms of up to ~20), with mu out to |u| ~ 20 where softplus
    saturates; softplus is logaddexp(x, 0), as jax.nn.softplus."""
    rng = np.random.default_rng(4)
    mu = rng.normal(0, 8, (64, 6)).astype(np.float32)
    ls = rng.uniform(-5, 2, (64, 6)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ja, jl = jsac._sample_tanh_gauss(key, jnp.asarray(mu), jnp.asarray(ls))
    noise = np.array(jax.random.normal(key, mu.shape, jnp.float32))
    ta, tl = tsac._sample_tanh_gauss(torch.from_numpy(noise),
                                     torch.from_numpy(mu),
                                     torch.from_numpy(ls))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-4)
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 25.0, 40.0])
    np.testing.assert_allclose(tsac._softplus(x).numpy(), np.asarray(
        jax.nn.softplus(jnp.asarray(x.numpy()))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# one train step against JAX
# ---------------------------------------------------------------------------

SAC_CASES = {
    # a block write from a misaligned written (5 -> slot 4)
    "box block": ("box", dict(capacity=8), 5),
    # per-step writes wrapping capacity 6, per-env sampling
    "box per-step": ("box", dict(capacity=6, per_env_sample=True), 5),
    "agent axis": ("agents_box", dict(capacity=8), 2),
}


@pytest.mark.parametrize("case", list(SAC_CASES))
def test_sac_train_step_matches_jax(case):
    """One train step from the same carry on JAX's draws: the actor,
    critics, targets, log_alpha, the ring, written, the carried obs and
    the metrics (module docstring's tolerances)."""
    kind, extra, written = SAC_CASES[case]
    kw = dict(num_envs=6, rollout_len=4, batch_per_env=3, updates=3,
              hidden=16, lr=1e-3, alpha_lr=1e-2, **extra)
    jcfg, tcfg = jsac.SACConfig(**kw), SACConfig(**kw)
    _, jstep, jcarry, tstep, carry = toy_carries(
        kind, jsac.make_sac_train_step, make_sac_train_step, jcfg, tcfg,
        written)
    key = jax.random.PRNGKey(7)
    draws = sac_draws(key, jcfg, kind, written)
    jcarry, jm = jax.jit(jstep)(jcarry, key)
    carry, m = tstep(carry, torch.Generator().manual_seed(0), draws=draws)
    compare_step(jcarry, jm, carry, m, ("actor", "critics", "targets"))
    assert int(carry["written"]) == written + 4


# ---------------------------------------------------------------------------
# the JAX tests' behaviours
# ---------------------------------------------------------------------------

def _building(tmp_path, name="building"):
    return make_env(name, "cpu", str(tmp_path))


def test_sac_train_step_runs_and_updates(tmp_path):
    """tests/test_sac.py::test_sac_train_step_runs_and_updates on the
    synthetic building: the actor moves, finite metrics, written ==
    rollout_len, the targets moved toward the critics but not onto
    them."""
    env, p = _building(tmp_path)
    cfg = SACConfig(num_envs=8, rollout_len=4, capacity=16, batch_per_env=2,
                    updates=2, hidden=32)
    init_state, train_step = make_sac_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    before = carry["actor"].mu.weight.detach().clone()
    t0 = carry["targets"]["q1"].l1.weight.detach().clone()
    carry, metrics = train_step(carry, gen)
    assert not torch.allclose(before, carry["actor"].mu.weight)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert int(carry["written"]) == cfg.rollout_len
    t = carry["targets"]["q1"].l1.weight
    o = carry["critics"]["q1"].l1.weight
    assert not torch.equal(t, t0) and not torch.allclose(t, o)


def test_sac_ring_buffer_wraps(tmp_path):
    """tests/test_sac.py::test_sac_ring_buffer_wraps: T 6 into capacity 4
    (per-step writes): written 6, four slots."""
    env, p = _building(tmp_path)
    cfg = SACConfig(num_envs=4, rollout_len=6, capacity=4, batch_per_env=2,
                    updates=1, hidden=16)
    init_state, train_step = make_sac_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(0)
    carry, _ = train_step(init_state(gen), gen)
    assert int(carry["written"]) == 6
    assert carry["buffer"]["obs"].shape[0] == 4
    assert bool((carry["buffer"]["obs"].abs().sum((1, 2)) > 0).all())


def test_sac_multiagent_building_smoke(tmp_path):
    """tests/test_sac.py::test_sac_multiagent_building_smoke: the agent
    axis in the ring, (capacity, envs, agents, D); finite metrics."""
    env, p = _building(tmp_path, "building-multiagent")
    cfg = SACConfig(num_envs=4, rollout_len=4, capacity=8, batch_per_env=2,
                    updates=2, hidden=16)
    init_state, train_step = make_sac_train_step(env, p, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    assert carry["buffer"]["obs"].ndim == 4
    assert carry["buffer"]["obs"].shape[:3] == (8, 4, len(env.agents))
    assert train_step.n_agents == len(env.agents)
    carry, metrics = train_step(carry, gen)
    assert all(np.isfinite(float(v)) for v in metrics.values())


class _QuadTrackEnv:
    """tests/test_ppo.py's _QuadTrackEnv in the port's protocol: reward =
    -||action - 0.3 * obs||^2, obs uniform in [-1, 1) from the
    generator, never done."""
    name = "quadtrack"

    def observation_space(self, params):
        return tcore.Box(-1, 1, (4,))

    def action_space(self, params):
        return tcore.Box(-1, 1, (4,))

    def _obs(self, generator, batch):
        return torch.rand((batch, 4), generator=generator) * 2 - 1

    def reset(self, params, generator, batch):
        obs = self._obs(generator, batch)
        no = torch.zeros(batch, dtype=torch.bool)
        return obs, tcore.TimeStep(obs=obs, reward=torch.zeros(batch),
                                   terminated=no, truncated=no, info={})

    def step(self, params, state, action, generator=None):
        reward = -torch.sum((action - 0.3 * state) ** 2, -1)
        obs = self._obs(generator, state.shape[0])
        no = torch.zeros(state.shape[0], dtype=torch.bool)
        return obs, tcore.TimeStep(obs=obs, reward=reward, terminated=no,
                                   truncated=no, info={})


def test_sac_learns_quadratic_tracking():
    """tests/test_sac.py::test_sac_learns_quadratic_tracking at its
    configuration and margin: the mean reward of the last three of 30
    iterations beats the first three's by 0.2."""
    cfg = SACConfig(num_envs=64, rollout_len=8, capacity=256, batch_per_env=8,
                    updates=16, hidden=32, lr=5e-3, alpha_lr=3e-2, gamma=0.0,
                    init_alpha=0.02)
    _, history = train_sac(_QuadTrackEnv(), CPU, cfg,
                           torch.Generator().manual_seed(0),
                           num_iterations=30, verbose=False)
    first = np.mean([h["mean_reward"] for h in history[:3]])
    last = np.mean([h["mean_reward"] for h in history[-3:]])
    assert last > first + 0.2, (first, last)


def test_sac_gates():
    """A discrete action space is refused, naming --algo ppo; MA cogen's
    per-agent policies with the JAX message; an env marked
    ppo_incompatible with its own message."""
    from sustaingym_tpu_torch import make
    env, p = make("electricitymarket", discrete=True, device="cpu",
                  horizon=2, lp_iters=20, lp_warm_iters=10)
    with pytest.raises(ValueError, match="--algo ppo"):
        make_sac_train_step(env, p, SACConfig())
    env, p = make("cogen-multiagent", device="cpu")
    with pytest.raises(ValueError, match="stacked per-agent policies"):
        make_sac_train_step(env, p, SACConfig())
    toy = TorchToy("box")
    toy.ppo_incompatible = "toy: not trainable"
    with pytest.raises(ValueError, match="not trainable"):
        make_sac_train_step(toy, CPU, SACConfig())


def test_sac_actor_fn_is_the_squashed_mean():
    """train_step.actor_fn: tanh(mu) mapped into the Box, on the raw
    obs."""
    init_state, train_step = make_sac_train_step(TorchToy("box"), CPU,
                                                 SACConfig(num_envs=4,
                                                           hidden=8))
    carry = init_state(torch.Generator().manual_seed(0))
    assert train_step.actor_key == "actor"
    obs = torch.randn(4, D)
    a = train_step.actor_fn(carry["actor"], obs)
    mu = tsac.actor_apply(carry["actor"], obs)[0]
    low = torch.tensor([-1.0, 0.0, -2.0])
    high = torch.tensor([1.0, 2.0, 0.5])
    torch.testing.assert_close(a, low + (torch.tanh(mu) + 1) * 0.5
                               * (high - low))


def test_sac_train_cli_runs_evaluates_and_resumes(tmp_path):
    """--algo sac on the CPU with --eval-every 1: train_results.csv with
    the SAC metrics, eval_results.csv and best_model; the checkpoint holds
    the whole carry and a resume takes the next iteration."""
    from sustaingym_tpu_torch import train
    log = tmp_path / "run"
    args = ["--env", "evcharging", "--algo", "sac", "--device", "cpu",
            "--num-envs", "4", "--rollout-len", "4", "--hidden", "16",
            "--iterations", "2", "--save-every", "1", "--eval-every", "1",
            "--eval-episodes", "2", "--log-dir", str(log),
            "--env-kwargs", '{"project_action": false}']
    train.main(args)
    rows = (log / "train_results.csv").read_text().splitlines()
    assert len(rows) == 3 and {"q_loss", "alpha", "entropy"} <= set(
        rows[0].split(","))
    assert len((log / "eval_results.csv").read_text().splitlines()) == 3
    assert os.listdir(log / "best_model")
    ckpt = torch.load(log / "checkpoints" / "step_2.pt", weights_only=True)
    assert {"actor", "critics", "targets", "log_alpha", "actor_opt",
            "critic_opt", "alpha_opt", "buffer", "written", "env_states",
            "obs"} <= set(ckpt["carry"])
    train.main(args + ["--restore", str(log / "checkpoints"),
                       "--iterations", "1"])
    rows = (log / "train_results.csv").read_text().splitlines()
    assert rows[-1].split(",")[rows[0].split(",").index("iteration")] == "2"
