"""PyTorch port of the PPO learner (sustaingym_tpu_torch.parallel) against
the JAX package's parallel.ppo and optax, plus the port's lr=0 exact-ratio
invariant, its train CLI and its import boundary."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sustaingym_tpu.parallel import ppo as jppo
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.parallel import (PPOConfig, from_jax,
                                           make_train_step, policy_apply,
                                           to_jax)
from sustaingym_tpu_torch.parallel import ppo as tppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, H = 146, 54, 64


def _jax_policy(seed=0):
    tree = jppo.init_policy(jax.random.PRNGKey(seed), D, N, H,
                            dtype=jnp.float32)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    # non-zero biases and log_std so every leaf is exercised
    rng = np.random.default_rng(seed)
    for k in ("trunk1", "trunk2", "mu", "value"):
        tree[k]["b"] = rng.normal(0, 0.1, tree[k]["b"].shape).astype(
            np.float32)
    tree["log_std"] = rng.normal(-0.5, 0.2, (N,)).astype(np.float32)
    return tree


def test_convert_roundtrip():
    tree = _jax_policy()
    policy = from_jax(tree, device="cpu")
    assert policy.trunk1.weight.shape == (H, D)
    back = to_jax(policy)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_policy_apply_and_logp_match_jax():
    tree = _jax_policy(1)
    rng = np.random.default_rng(2)
    obs = rng.normal(0, 1, (32, D)).astype(np.float32)
    u = rng.normal(0, 1, (32, N)).astype(np.float32)
    jmu, jls, jv = jppo.policy_apply(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(obs))
    tmu, tls, tv = policy_apply(from_jax(tree, device="cpu"),
                                torch.from_numpy(obs))
    for t, j in ((tmu, jmu), (tls, jls), (tv, jv)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)
    jl = jppo._gauss_logp(jmu, jls, jnp.asarray(u))
    tl = tppo._gauss_logp(tmu, tls, torch.from_numpy(u))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)


def test_default_act_transform_matches_jax():
    from sustaingym_tpu import make as jmake
    jenv, jp = jmake("evcharging", project_action=False)
    env, params = make("evcharging", project_action=False, device="cpu")
    u = np.random.default_rng(6).normal(0, 2, (8, N)).astype(np.float32)
    a = tppo.default_act_transform(env, params)(torch.from_numpy(u))
    ja = jppo.default_act_transform(jenv, jp)(jnp.asarray(u))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)


def _jax_gae(cfg, value, reward, done, last_value):
    """parallel/ppo.py's GAE scan (a closure inside make_train_step)."""
    def body(carry, x):
        adv_next, v_next = carry
        value, reward, done = x
        nonterm = 1.0 - done.astype(reward.dtype)
        delta = reward + cfg.gamma * v_next * nonterm - value
        adv = delta + cfg.gamma * cfg.lam * nonterm * adv_next
        return (adv, value), adv

    (_, _), advs = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value),
        (value, reward, done), reverse=True)
    return advs, advs + value


def test_gae_matches_jax():
    cfg = PPOConfig()
    rng = np.random.default_rng(3)
    T, B = 40, 16
    value = rng.normal(0, 1, (T, B)).astype(np.float32)
    reward = rng.normal(0, 1, (T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.1
    last = rng.normal(0, 1, (B,)).astype(np.float32)
    ja, jr = _jax_gae(cfg, *(jnp.asarray(x) for x in (value, reward, done,
                                                      last)))
    ta, tr = tppo.gae(cfg, *(torch.from_numpy(x) for x in (value, reward,
                                                           done, last)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])
def test_clip_adam_update_matches_optax(grad_scale):
    """Global-norm clip + Adam: three updates equal optax's chain, with the
    clip active (norm >> 0.5) and inactive."""
    tree = _jax_policy(4)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda x: (rng.normal(0, 1, x.shape) * grad_scale
                                     ).astype(np.float32), tree)
             for _ in range(3)]
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jparams = jax.tree.map(jnp.asarray, tree)
    state = opt.init(jparams)
    policy = from_jax(tree, device="cpu")
    topt = torch.optim.Adam(policy.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        gp = from_jax(g, device="cpu")
        for p, q in zip(policy.parameters(), gp.parameters()):
            p.grad = q.detach().clone()
        tppo.clip_by_global_norm(policy.parameters(), 0.5)
        topt.step()
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(to_jax(policy))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize("act_dim,n_bins", [(1, 3), (6, 5)])
def test_categorical_logp_and_entropy_match_jax(act_dim, n_bins):
    """The categorical head's log-prob at the chosen bins and its entropy,
    against the JAX package's functions on the same logits."""
    rng = np.random.default_rng(act_dim)
    logits = rng.normal(0, 2, (32, act_dim, n_bins)).astype(np.float32)
    idx = rng.integers(0, n_bins, (32, act_dim))
    jl = jppo._categorical_logp(jnp.asarray(logits), jnp.asarray(idx))
    tl = tppo._categorical_logp(torch.from_numpy(logits),
                                torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    je = jppo._categorical_entropy(jnp.asarray(logits))
    te = tppo._categorical_entropy(torch.from_numpy(logits))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-6)


def test_categorical_draws_are_gumbel_max():
    """The sampling policy's bins: argmax of logits plus Gumbel noise
    from the generator (jax.random.categorical's rule), so a dominant
    logit always wins and equal logits give uniform bins."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros((20000, 2, 4))
    logits[:, 1, 2] = 50.0
    u = tppo._sample_categorical(logits, gen)
    assert u.shape == (20000, 2) and u.dtype == torch.long
    assert torch.equal(u[:, 1], torch.full((20000,), 2))
    share = torch.bincount(u[:, 0], minlength=4).float() / 20000
    assert torch.all((share - 0.25).abs() < 0.015), share


@pytest.mark.parametrize("discrete", [False, True])
def test_a2c_pg_loss_matches_jax_formula(discrete):
    """A2C's policy loss, -(logp * normalised adv).mean() (the JAX
    package's loss, sustaingym_tpu/parallel/ppo.py:572-573), on the same
    policy and batch, with the Gaussian and the categorical head."""
    n_bins = 3 if discrete else 0
    width = 2 * n_bins if discrete else N
    tree = _jax_policy(8)
    rng = np.random.default_rng(8)
    tree["mu"]["w"] = rng.normal(0, 0.1, (H, width)).astype(np.float32)
    tree["mu"]["b"] = rng.normal(0, 0.1, (width,)).astype(np.float32)
    tree["log_std"] = rng.normal(-0.5, 0.2, (width,)).astype(np.float32)
    obs = rng.normal(0, 1, (64, D)).astype(np.float32)
    u = (rng.integers(0, 3, (64, 2)) if discrete
         else rng.normal(0, 1, (64, N)).astype(np.float32))
    adv = rng.normal(0, 2, (64,)).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    mu, ls, _ = jppo.policy_apply(jtree, jnp.asarray(obs))
    if discrete:
        jl = jppo._categorical_logp(mu.reshape(64, 2, 3), jnp.asarray(u))
    else:
        jl = jppo._gauss_logp(mu, ls, jnp.asarray(u))
    a = jnp.asarray(adv)
    want = -(jl * ((a - a.mean()) / (a.std() + 1e-8))).mean()
    batch = {"obs": torch.from_numpy(obs), "u": torch.from_numpy(u),
             "adv": torch.from_numpy(adv), "logp": torch.zeros(64),
             "ret": torch.zeros(64)}
    _, m = tppo.loss_fn(from_jax(tree, device="cpu"), batch,
                        PPOConfig(algo="a2c"), tppo._apply_f32, n_bins)
    np.testing.assert_allclose(float(m["pg_loss"].detach()), float(want),
                               rtol=1e-5, atol=1e-6)


def _present_update(policy, opt, flat, cfg, generator, apply):
    """The minibatch epochs as the port ran them before the captured
    update: a randperm per epoch, minibatch by minibatch."""
    n = flat["logp"].shape[0]
    mb = n // cfg.minibatches
    sums = {}
    for _ in range(cfg.epochs):
        perm = torch.randperm(n, generator=generator)
        for k in range(cfg.minibatches):
            idx = perm[k * mb:(k + 1) * mb]
            batch = {key: v[idx] for key, v in flat.items()}
            loss, metrics = tppo.loss_fn(policy, batch, cfg, apply)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            tppo.clip_by_global_norm(policy.parameters(), cfg.max_grad_norm)
            opt.step()
            for key, v in metrics.items():
                sums[key] = sums.get(key, 0.0) + v.detach()
    return sums


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_update_and_score_match_the_present_loop(algo):
    """The refactored score (re-scoring + GAE) and update (the body a CUDA
    graph captures, run eagerly on the CPU) against the loop they replace,
    from the same carry and generator state: bit for bit."""
    env, params = make("cogen", device="cpu")
    cfg = PPOConfig(num_envs=16, hidden=32, minibatches=4, epochs=3,
                    reward_scale=1e-4, algo=algo)
    init_state, train_step = make_train_step(env, params, cfg)
    assert train_step.graphs is None
    gen = torch.Generator().manual_seed(3)
    carry = init_state(gen)
    out = train_step.rollout(carry["policy"], gen)
    flat = train_step.score(carry["policy"], out)
    mu, log_std, value = tppo._apply_f32(carry["policy"], out["obs"])
    adv, ret = tppo.gae(cfg, value, out["reward"] * cfg.reward_scale,
                        out["done"], torch.zeros_like(value[0]))
    want = {"logp": tppo._gauss_logp(mu, log_std, out["u"]).reshape(-1),
            "adv": adv.reshape(-1), "ret": ret.reshape(-1)}
    for key, v in want.items():
        assert torch.equal(flat[key], v), key
    twin = init_state(torch.Generator().manual_seed(3))
    twin["policy"].load_state_dict(carry["policy"].state_dict())
    state = gen.get_state()
    sums = train_step.update(carry["policy"], carry["opt"], flat, gen)
    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(state)
    ref = _present_update(twin["policy"], twin["opt"], flat, cfg, gen2,
                          tppo._apply_f32)
    for key in ref:
        assert torch.equal(sums[key], ref[key]), key
    for a, b in zip(carry["policy"].parameters(),
                    twin["policy"].parameters()):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen2.get_state())


def test_graphs_on_the_cpu_call_the_function():
    """On the CPU a Graphs object calls the function (repeat times) and
    captures nothing; device constants are made once per value."""
    from sustaingym_tpu_torch.core.graph import (Graphs, device_const,
                                                 device_index)
    graphs = Graphs("cpu")
    counter = torch.zeros(1)

    def fn(x, c):
        c.add_(1)
        return x * c

    out = graphs("k", fn, torch.ones(3), counter, repeat=4)
    assert torch.equal(out, torch.full((3,), 4.0))
    assert graphs.captures == 0 and not graphs.on_card
    a = device_const(np.array([1.5, 2.0]), "cpu")
    assert a is device_const(np.array([1.5, 2.0]), "cpu")
    assert a.dtype == torch.float32
    assert torch.equal(device_index((2, 0), "cpu"), torch.tensor([2, 0]))


@pytest.mark.parametrize("name", ["cogen", "datacenter",
                                  "electricitymarket"])
def test_batch_rollout_calls_a_stateful_policy_every_step(name):
    """Without ``graphs`` batch_rollout's lockstep path calls the policy at
    every step: a policy with Python state (a step counter, host copies
    of the obs) sees each step, across an episode boundary too."""
    from sustaingym_tpu_torch.core import batch_rollout, random_policy
    env, params = make(name, device="cpu")
    B, T = 2, env.episode_steps(params) + 3
    draw, seen = random_policy(env, params, B), []

    def policy(_, obs, generator):
        seen.append(float(np.sum([np.sum(x.numpy()) for x in
                                  (obs.values() if isinstance(obs, dict)
                                   else [obs])])))
        return draw(None, obs, generator)

    traj = batch_rollout(env, params, policy, None,
                         torch.Generator().manual_seed(0), B, T)
    assert len(seen) == T and traj.reward.shape == (T, B)
    assert all(np.isfinite(seen))


def test_make_train_step_rejects_unknown_algo():
    env, params = make("cogen", device="cpu")
    with pytest.raises(ValueError, match="algo"):
        make_train_step(env, params, PPOConfig(algo="sac"))


def test_train_step_lr0_exact_ratio():
    """lr=0: the stored behaviour logp equals every re-scored logp, so each
    ratio is exactly 1 and pg_loss vanishes (the JAX package's
    test_fused_policy_rollout_lr0_and_learns invariant), on the CPU plain
    version of the policy kernel with the projection on."""
    env, params = make("evcharging", site="caltech", device="cpu")
    cfg = PPOConfig(num_envs=128, hidden=H, minibatches=4, epochs=1, lr=0.0,
                    obs_bf16=True)
    init_state, train_step = make_train_step(env, params, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    w0 = carry["policy"].trunk1.weight.detach().clone()
    carry, metrics = train_step(carry, gen)
    m = {k: float(v) for k, v in metrics.items()}
    assert abs(m["pg_loss"]) < 1e-5, m
    assert np.isfinite(m["vf_loss"]) and m["vf_loss"] > 0
    assert m["episode_done_frac"] == pytest.approx(1.0 / 288)
    assert torch.equal(carry["policy"].trunk1.weight, w0)


def test_make_train_step_rejects_unported_paths(tmp_path):
    """An env without a batched step (and no batch_unroll or fused
    rollout) is refused; EV with float32 obs trains on the episodic path
    (its batch_unroll), and at --rollout-len 64 on the generic path."""
    from sustaingym_tpu_torch import train
    env, params = make("evcharging", site="caltech", project_action=False,
                       device="cpu")

    class GenericEnv:
        def episode_steps(self, params):
            return env.episode_steps(params)

    with pytest.raises(ValueError, match="step"):
        make_train_step(GenericEnv(), params, PPOConfig())
    _, step = make_train_step(env, params, PPOConfig(obs_bf16=False))
    assert step.path == "episodic" and step.rollout_len == 288
    _, step = make_train_step(env, params, PPOConfig(rollout_len=64))
    assert step.path == "generic" and step.rollout_len == 64
    train.main(["--device", "cpu", "--rollout-len", "64", "--num-envs",
                "8", "--hidden", "16", "--minibatches", "2", "--epochs",
                "1", "--iterations", "1", "--log-dir", str(tmp_path),
                "--env-kwargs", '{"project_action": false}'])
    assert (tmp_path / "train_results.csv").exists()


def test_package_imports_no_jax():
    code = ("import sys, sustaingym_tpu_torch, sustaingym_tpu_torch.train, "
            "sustaingym_tpu_torch.parallel, sustaingym_tpu_torch.ops.cuda."
            "ev_rollout, sustaingym_tpu_torch.ops.cuda.cogen_rollout, "
            "sustaingym_tpu_torch.ops.cuda.exog_gather, "
            "sustaingym_tpu_torch.ops.cuda.build, "
            "sustaingym_tpu_torch.ops.cuda.building_rollout, "
            "sustaingym_tpu_torch.envs.building, "
            "sustaingym_tpu_torch.envs.building.synthetic, "
            "sustaingym_tpu_torch.core.rollout, "
            "sustaingym_tpu_torch.core.graph, sustaingym_tpu_torch.bench, "
            "sustaingym_tpu_torch.data.ev_gmm, "
            "sustaingym_tpu_torch.envs.multiagent, "
            "sustaingym_tpu_torch.parallel.replay, "
            "sustaingym_tpu_torch.parallel.offpolicy, "
            "sustaingym_tpu_torch.parallel.sac, "
            "sustaingym_tpu_torch.parallel.dqn, "
            "sustaingym_tpu_torch.parallel.ddpg, "
            "sustaingym_tpu_torch.parallel.runner, "
            "sustaingym_tpu_torch.parallel.convert; "
            "sustaingym_tpu_torch.make('evcharging', device='cpu'); "
            "sustaingym_tpu_torch.make('cogen', device='cpu'); "
            "sustaingym_tpu_torch.make('evcharging-multiagent', "
            "periods_delay=2, device='cpu'); "
            "sustaingym_tpu_torch.make('cogen-multiagent', device='cpu'); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'sustaingym_tpu.')) or m == 'sustaingym_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_train_cli_cpu(tmp_path):
    from sustaingym_tpu_torch import train
    args = ["--env", "evcharging", "--algo", "ppo", "--device", "cpu",
            "--num-envs", "16", "--hidden", "16", "--minibatches", "2",
            "--epochs", "1", "--iterations", "2", "--save-every", "1",
            "--obs-bf16", "--log-dir", str(tmp_path),
            "--env-kwargs", '{"project_action": false}']
    train.main(args)
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert len(rows) == 3 and "pg_loss" in rows[0]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "step_1.pt", "step_2.pt"]
    train.main(args + ["--restore", str(tmp_path / "checkpoints"),
                       "--iterations", "1"])
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert rows[-1].split(",")[rows[0].split(",").index("iteration")] == "2"


def test_train_cli_refuses_missing_cuda(tmp_path):
    from sustaingym_tpu_torch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit):
        train.main(["--env", "evcharging", "--device", "cuda", "--obs-bf16",
                    "--log-dir", str(tmp_path)])


@pytest.mark.parametrize("name", ["evcharging", "cogen", "datacenter",
                                  "electricitymarket",
                                  "evcharging-multiagent",
                                  "building-multiagent", "cogen-multiagent"])
def test_entry_points_default_to_the_card(name, tmp_path):
    """make(), make_params(), from_jax() (of the PPO policy and of the
    off-policy networks) and the CLI (every algorithm) build on the card
    unless asked for the CPU; without a card the default raises instead of
    moving to the CPU."""
    from sustaingym_tpu_torch import train
    from sustaingym_tpu_torch.envs import (building, cogen, datacenter,
                                           electricitymarket, evcharging,
                                           multiagent)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(name)
    params = {"evcharging": evcharging.make_params,
              "cogen": cogen.make_params,
              "datacenter": datacenter.make_params,
              "electricitymarket": electricitymarket.make_params,
              "evcharging-multiagent": multiagent.make_ma_ev_params,
              "building-multiagent": building.make_env,
              "cogen-multiagent": cogen.make_params}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params[name]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(_jax_policy())
    from sustaingym_tpu.parallel import dqn as jdqn
    from sustaingym_tpu.parallel import sac as jsac
    for tree in (jsac.init_actor(jax.random.PRNGKey(0), 4, 2, 8),
                 {"q1": jsac.init_critic(jax.random.PRNGKey(1), 4, 2, 8),
                  "q2": jsac.init_critic(jax.random.PRNGKey(2), 4, 2, 8)},
                 jdqn.init_qnet(jax.random.PRNGKey(3), 4, 2, 3, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_jax(tree)
    with pytest.raises(SystemExit):
        train.main(["--env", name, "--obs-bf16", "--log-dir", str(tmp_path)])
    for algo in ("sac", "dqn", "ddpg"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            train.main(["--env", name, "--algo", algo, "--log-dir",
                        str(tmp_path)])


def _generic(rollout_len=16, num_envs=8, **kw):
    """An EV trainer on the generic rollout (float32 obs, projection on)."""
    env, params = make("evcharging", site="caltech", device="cpu")
    cfg = PPOConfig(num_envs=num_envs, hidden=16, minibatches=2, epochs=1,
                    rollout_len=rollout_len, **kw)
    init_state, train_step = make_train_step(env, params, cfg)
    assert train_step.path == "generic"
    return env, params, cfg, init_state, train_step


def test_generic_gae_bootstraps_from_the_last_obs():
    """The generic rollout's re-scoring: GAE over a rollout that crosses an
    episode end (the envs' clocks set to 280 of 288) and bootstraps from
    the value of the obs after its last step, against the JAX package's
    GAE scan on the values of its policy_apply (rtol 1e-5 / atol 1e-5)."""
    _, _, cfg, init_state, train_step = _generic(rollout_len=16)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    carry["env_states"].t.fill_(280)
    carry["env_phase"].fill_(280)     # the reset schedule's clock too
    out = train_step.rollout(carry["policy"], gen, carry)
    done = out["done"].numpy()
    assert done[7].all() and done.sum() == done.shape[1]
    assert int(carry["env_states"].t[0]) == 8
    flat = train_step.score(carry["policy"], out)
    tree = tppo_convert_to_jax(carry["policy"])
    _, _, value = jppo.policy_apply(tree, jnp.asarray(out["obs"].numpy()))
    _, _, last = jppo.policy_apply(tree, jnp.asarray(out["last_obs"].numpy()))
    assert float(jnp.abs(last).max()) > 0
    adv, ret = _jax_gae(cfg, value, jnp.asarray(out["reward"].numpy()),
                        jnp.asarray(done), last)
    np.testing.assert_allclose(flat["adv"].numpy(), np.asarray(adv).ravel(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flat["ret"].numpy(), np.asarray(ret).ravel(),
                               rtol=1e-5, atol=1e-5)


def tppo_convert_to_jax(policy):
    return jax.tree.map(jnp.asarray, to_jax(policy))


def test_generic_lr0_exact_ratio():
    """lr=0 at rollout_len 64: every ratio is exactly 1 on the generic
    path (float32 obs, projection on), the weights do not move."""
    _, _, _, init_state, train_step = _generic(rollout_len=64, lr=0.0)
    gen = torch.Generator().manual_seed(1)
    carry = init_state(gen)
    w0 = carry["policy"].trunk1.weight.detach().clone()
    carry, metrics = train_step(carry, gen)
    m = {k: float(v) for k, v in metrics.items()}
    assert abs(m["pg_loss"]) < 1e-5, m
    assert np.isfinite(m["vf_loss"]) and m["episode_done_frac"] == 0.0
    assert torch.equal(carry["policy"].trunk1.weight, w0)


def test_generic_carry_crosses_train_steps():
    """The envs' states and obs carry from one train step to the next:
    after 5 x 64 steps every env has ended one episode and stands at
    t = 320 - 288 = 32; its obs is the carried one."""
    env, params, _, init_state, train_step = _generic(rollout_len=64)
    gen = torch.Generator().manual_seed(2)
    carry = init_state(gen)
    done = []
    for _ in range(5):
        carry, metrics = train_step(carry, gen)
        done.append(float(metrics["episode_done_frac"]))
    assert (carry["env_states"].t == 32).all()
    assert done == [0.0, 0.0, 0.0, 0.0, pytest.approx(1.0 / 64)]
    np.testing.assert_allclose(carry["obs"]["timestep"].numpy(), 32 / 288)


def test_generic_checkpoint_round_trips_the_env_carry(tmp_path):
    """train.save_checkpoint / restore_checkpoint keep the generic
    rollout's env states and obs: a fresh trainer restored after one step
    takes the same second step as the trainer that ran on."""
    from sustaingym_tpu_torch import train
    _, _, _, init_state, train_step = _generic(rollout_len=20)
    gen = torch.Generator().manual_seed(3)
    carry = init_state(gen)
    carry, _ = train_step(carry, gen)
    train.save_checkpoint(str(tmp_path), carry, gen, 1)
    carry, m1 = train_step(carry, gen)
    _, _, _, init2, step2 = _generic(rollout_len=20)
    gen2 = torch.Generator().manual_seed(99)
    carry2 = init2(gen2)
    assert train.restore_checkpoint(str(tmp_path), carry2, gen2) == 1
    assert int(carry2["env_states"].t[0]) == 20
    carry2, m2 = step2(carry2, gen2)
    assert {k: float(v) for k, v in m1.items()} == {
        k: float(v) for k, v in m2.items()}
    for a, b in zip(carry["policy"].parameters(),
                    carry2["policy"].parameters()):
        assert torch.equal(a, b)
    assert torch.equal(carry["env_states"].demand,
                       carry2["env_states"].demand)


def test_train_cli_eval_callback(tmp_path):
    """--rollout-len 64 with --eval-every (tests/test_train_cli.py's eval
    test): eval_results.csv holds the mean return and the float info
    fields, best_model holds the best; a resumed run reads its best from
    the CSV; a CSV with another header is refused."""
    from sustaingym_tpu_torch import train
    log = tmp_path / "run"
    args = ["--env", "evcharging", "--device", "cpu", "--num-envs", "8",
            "--rollout-len", "64", "--hidden", "16", "--minibatches", "2",
            "--epochs", "1", "--eval-every", "2", "--eval-episodes", "2",
            "--iterations", "2", "--save-every", "100", "--log-dir",
            str(log)]
    train.main(args)
    rows = (log / "eval_results.csv").read_text().splitlines()
    header = rows[0].split(",")
    assert len(rows) == 2 and header[:2] == ["iteration", "mean_return"]
    assert {"profit", "carbon_cost", "excess_charge",
            "max_profit"} <= set(header) and "num_evs" not in header
    assert np.isfinite(float(rows[1].split(",")[1]))
    assert os.listdir(log / "best_model") == ["step_2.pt"]
    assert train.read_best(str(log / "eval_results.csv")) == float(
        rows[1].split(",")[1])
    train.main(args + ["--restore", str(log / "checkpoints")])
    rows = (log / "eval_results.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[2].split(",")[0] == "4"
    best = max(float(r.split(",")[1]) for r in rows[1:])
    assert train.read_best(str(log / "eval_results.csv")) == best
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "eval_results.csv").write_text(
        "iteration,mean_return,comfort_level\n1,0.5,0.1\n")
    with pytest.raises(SystemExit, match="columns"):
        train.main(args[:-1] + [str(tmp_path / "other")])
