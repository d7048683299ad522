"""The port's distribution on ``torch.distributed``
(``sustaingym_tpu_torch.parallel.{distributed,mesh}``) against the JAX
package's seed contract (tests/test_debug_distributed.py:103-183): the
same global seed gives the same global batch for any rank count, rank r
owns rows [r B / R, (r + 1) B / R), a batch the ranks do not divide
raises; a real 2-process gloo group trains like one process; and the mp
split of the MLP against the unsplit one. The kernels' ``env_offset``
(their plain versions here; tests/test_torch_gpu_kernels.py holds the
kernels on the card)."""
import numpy as np
import pytest
import torch

from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.bench import make_env
from sustaingym_tpu_torch.bench_scaling import equivalence
from sustaingym_tpu_torch.core import draw_env_rows, env_shard
from sustaingym_tpu_torch.ops.cuda import building_rollout as K5
from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
from sustaingym_tpu_torch.parallel import (init_policy, init_stacked_policy,
                                           make_mesh, process_local_batch,
                                           process_rows, spawn)
from sustaingym_tpu_torch.parallel.ppo import (clip_by_global_norm,
                                               mp_param_axes,
                                               per_agent_apply, policy_apply,
                                               shard_policy)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_process_rows_partition_the_global_batch(count):
    rows = [np.arange(32)[process_rows(32, r, count)] for r in range(count)]
    assert all(len(x) == 32 // count for x in rows)
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(32))
    assert process_local_batch(32, count) == 32 // count


def test_divisibility_guard_raises_value_error():
    # ValueError, not assert: must survive `python -O`
    with pytest.raises(ValueError):
        process_rows(10, 0, 4)
    with pytest.raises(ValueError):
        process_local_batch(10, 4)
    with pytest.raises(ValueError), env_shard(0, 2, 8):
        draw_env_rows(lambda b: torch.zeros(b), 3)


@pytest.mark.parametrize("ranks", [2, 4])
def test_env_shard_draws_the_global_batch(ranks):
    """Each rank's reset days are its rows of the one-process draw, and
    every rank's generator ends where the one-process generator ends."""
    env, params = make("evcharging", device="cpu")
    B = 16
    g1 = torch.Generator().manual_seed(3)
    s1, _ = env.reset(params, g1, B)
    want = env._episode_days(params, B, 2, None, g1)
    b = B // ranks
    days, eps = [], []
    for r in range(ranks):
        g = torch.Generator().manual_seed(3)
        with env_shard(r * b, b, B):
            s, _ = env.reset(params, g, b)
            eps.append(env._episode_days(params, b, 2, None, g))
        days.append(s.day)
        assert torch.equal(g.get_state(), g1.get_state())
    assert torch.equal(torch.cat(days), s1.day)
    assert torch.equal(torch.cat(eps, 1), want)


def test_ev_policy_plain_env_offset_slices():
    """ev_policy_segment's plain version at env_offset o over b envs draws
    rows [o, o + b) of the launch over all envs."""
    env, p = make("evcharging", device="cpu")
    n, k = p.n_stations, p.moer_forecast_steps
    w = K.pack_policy_weights(init_policy(2 + 2 * n + k, n, 16,
                                          torch.Generator().manual_seed(0)))
    days = torch.randint(p.n_days, (6,), generator=torch.Generator()
                         .manual_seed(1))
    full = K.ev_policy_segment(p, w, days, 4, seed=9)
    for o, b in ((0, 2), (2, 3), (5, 1)):
        part = K.ev_policy_segment(p, w, days[o:o + b], 4, seed=9,
                                   env_offset=o)
        for x, y in zip(part, full):
            assert torch.equal(x, y[:, o:o + b])


def test_building_policy_plain_env_offset_slices(tmp_path):
    _, p = make_env("building", "cpu", str(tmp_path))
    w = K.pack_policy_weights(init_policy(p.n + 4, p.n, 16,
                                          torch.Generator().manual_seed(0)))
    epochs = torch.arange(5) * 7
    full = K5.building_policy_segment(p, w, epochs, 6, seed=4)
    part = K5.building_policy_segment(p, w, epochs[2:], 6, seed=4,
                                      env_offset=2)
    for x, y in zip(part, full):
        assert torch.equal(x, y[:, 2:])


def test_two_process_gloo_ppo_matches_one_process():
    """A real 2-process gloo group (the EV generic trainer, 8 global envs)
    runs 3 PPO train steps equal to one process on the same global batch.
    Tolerance rtol 1e-4 / atol 1e-6: the update's sums (the advantages'
    normalisation, the loss, the gradients' all-reduce) run in another
    order, and Adam carries the difference from step to step (measured
    2e-5 relative). The ranks' parameters and generators are bit-equal,
    and their generators are in the one-process run's state."""
    eq = equivalence(2, "evcharging", 8, 16, steps=3, device="cpu")
    assert eq["params_equal_across_ranks"]
    assert eq["generator_equal_across_ranks"]
    assert eq["generator_equal_to_one_rank"]
    assert len(eq["metrics_dpN"]) == 3
    for one, two in zip(eq["metrics_dp1"], eq["metrics_dpN"]):
        for key in one:
            np.testing.assert_allclose(two[key], one[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def _mp_case(stacked: bool):
    """One rank of the mp = 2 check: the split MLP's outputs, its
    gradients gathered whole, and the clip's norm."""
    torch.manual_seed(0)
    mesh = make_mesh(mp=2, device="cpu")
    gen = torch.Generator().manual_seed(5)
    if stacked:
        policy = init_stacked_policy(3, 6, 2, 8, gen)
        obs = torch.randn((5, 3, 6), generator=gen)
        apply = per_agent_apply
    else:
        policy = init_policy(6, 2, 8, gen)
        obs = torch.randn((5, 6), generator=gen)
        apply = policy_apply
    shard_policy(policy, mesh)
    mu, log_std, value = apply(policy, obs)
    loss = (mu ** 2).sum() + value.sum() + log_std.sum()
    loss.backward()
    norm = clip_by_global_norm(policy.parameters(), 0.5, mesh,
                               mp_param_axes(policy))
    grads = {}
    axes = {name: axis for name, axis in mp_param_axes(policy).values()}
    for name, p in policy.named_parameters():
        g = p.grad
        grads[name] = (mesh.unshard(g, axes[name]) if name in axes
                       else g).numpy()
    return mu.detach().numpy(), value.detach().numpy(), float(norm), grads


@pytest.mark.parametrize("stacked", [False, True])
def test_mp2_mlp_matches_the_unsplit_one(stacked):
    """The Megatron split over 2 ranks (trunk1 column-, trunk2 row-
    parallel, the partial sums all-reduced before the bias; stacked
    weights split on H, not the agent axis): forward, backward and the
    global-norm clip (each parameter counted once) equal the unsplit
    MLP's to float32 rounding."""
    ranks = spawn(_mp_case, 2, (stacked,), device="cpu", timeout=120)
    gen = torch.Generator().manual_seed(5)
    if stacked:
        policy = init_stacked_policy(3, 6, 2, 8, gen)
        obs = torch.randn((5, 3, 6), generator=gen)
        mu, log_std, value = per_agent_apply(policy, obs)
    else:
        policy = init_policy(6, 2, 8, gen)
        obs = torch.randn((5, 6), generator=gen)
        mu, log_std, value = policy_apply(policy, obs)
    ((mu ** 2).sum() + value.sum() + log_std.sum()).backward()
    norm = float(clip_by_global_norm(policy.parameters(), 0.5))
    for r_mu, r_value, r_norm, r_grads in ranks:
        np.testing.assert_allclose(r_mu, mu.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r_value, value.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert r_norm == pytest.approx(norm, rel=1e-5)
        for name, p in policy.named_parameters():
            np.testing.assert_allclose(r_grads[name], p.grad.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_capture_true_with_ranks_and_fused_with_mp_raise():
    """No silent change of mode: capture=True with more than one rank
    raises, and so does asking for the fused path under an mp split."""
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    from sustaingym_tpu_torch.parallel.mesh import Mesh
    env, p = make("evcharging", device="cpu")
    two = Mesh(dp=2, mp=1, d=0, m=0, device=torch.device("cpu"))
    split = Mesh(dp=1, mp=2, d=0, m=0, device=torch.device("cpu"))
    cfg = PPOConfig(num_envs=4, hidden=16, obs_bf16=True)
    with pytest.raises(ValueError, match="capture=True"):
        make_train_step(env, p, cfg, capture=True, mesh=two)
    _, step = make_train_step(env, p, cfg, path="fused")
    assert step.path == "fused"
    with pytest.raises(ValueError, match="whole weights"):
        make_train_step(env, p, cfg, mesh=split, path="fused")
    _, step = make_train_step(env, p, cfg, mesh=split)
    assert step.path == "episodic"
