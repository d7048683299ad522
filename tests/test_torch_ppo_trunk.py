"""The PPO trunk's glue passes (``ops/cuda/ppo_trunk.py``): on the CPU their
plain versions, through the trunk's autograd binding, against
``policy_apply_bf16_ref`` and autograd through it; the width check; the
GEMM's plain version. On a card (``gpu`` marker, each test skips without
one) the kernels against the plain versions on the same card tensors,
their determinism, the trunk against the autograd chain it replaces, and
the launches of a captured train step:

    python -m pytest tests/test_torch_ppo_trunk.py -q -m gpu
"""
from __future__ import annotations

import pytest
import torch

from sustaingym_tpu_torch.ops.cuda import ppo_trunk as K
from sustaingym_tpu_torch.parallel import ppo
from sustaingym_tpu_torch.parallel.ppo import init_policy

# the EV trainer's obs and action widths
OBS, ACT = 146, 54


def _policy(H, device, seed=0):
    return init_policy(OBS, ACT, H, torch.Generator().manual_seed(seed),
                       device)


def _run(apply, policy, obs, cot_mu, cot_v):
    """``apply``'s (mu, value) and the gradients of every parameter under
    the cotangents."""
    for p in policy.parameters():
        p.grad = None
    mu, _, value = apply(policy, obs)
    ((mu * cot_mu).sum() + (value * cot_v).sum()).backward()
    grads = {n: p.grad.clone() for n, p in policy.named_parameters()
             if p.grad is not None}
    return mu.detach().clone(), value.detach().clone(), grads


@pytest.mark.parametrize("H", [256, 32, 64])
def test_trunk_plain_passes_match_the_bf16_reference(H):
    """The trunk's route with its plain passes (1000 rows of the EV obs)
    against ``policy_apply_bf16_ref``: mu and value to float32 rounding
    (the two heads are one product here), the gradients of every
    parameter through autograd: the bf16-rounded weight gradients within
    one bf16 step, the float32 bias gradients to the float32 rounding of
    another summation order."""
    g = torch.Generator().manual_seed(H)
    policy = _policy(H, torch.device("cpu"), seed=H)
    obs = torch.randn((1000, OBS), generator=g).bfloat16()
    cot_mu = torch.randn((1000, ACT), generator=g)
    cot_v = torch.randn((1000,), generator=g)
    before = K.ppo_trunk.launches
    mu, value, grads = _run(ppo._apply_trunk, policy, obs, cot_mu, cot_v)
    assert K.ppo_trunk.launches == before
    mu_r, value_r, grads_r = _run(ppo.policy_apply_bf16_ref, policy, obs,
                                  cot_mu, cot_v)
    torch.testing.assert_close(mu, mu_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(value, value_r, rtol=1e-5, atol=1e-5)
    assert set(grads) == set(grads_r) == {
        n for n, _ in policy.named_parameters()} - {"log_std"}
    for name, want in grads_r.items():
        scale = float(want.abs().max())
        if name.endswith("weight"):
            torch.testing.assert_close(grads[name], want, rtol=2 ** -7,
                                       atol=1e-6 * scale)
        else:
            torch.testing.assert_close(grads[name], want, rtol=1e-5,
                                       atol=1e-5 * scale)


def test_trunk_without_grad_stores_no_activation():
    """With grad off (the scoring pass) the forward passes keep no float32
    activation and leave the GEMM's output as it was; the product equals
    the differentiable route's."""
    g = torch.Generator().manual_seed(1)
    policy = _policy(32, torch.device("cpu"))
    obs = torch.randn((77, OBS), generator=g).bfloat16()
    with torch.no_grad():
        scored = ppo._apply_trunk(policy, obs)
    trained = ppo._apply_trunk(policy, obs)
    for a, b in zip(scored, trained):
        assert torch.equal(a, b.detach())
    a = torch.randn((77, 32), generator=g)
    kept = a.clone()
    y, h = K.trunk_forward(a, torch.randn(32, generator=g), keep=False)
    assert y is None and torch.equal(a, kept) and h.dtype == torch.bfloat16
    y, h = K.trunk_forward(a, torch.zeros(32), keep=True)
    assert y is a and torch.equal(a, torch.tanh(kept))
    assert torch.equal(h, a.to(torch.bfloat16))


def test_trunk_backward_pass_plain_version():
    """The plain backward pass: d = bf16-rounded p times tanh's
    derivative over p, hf = bf16-rounded y over y, the column sums, the
    float32 copy of x."""
    g = torch.Generator().manual_seed(2)
    p = torch.randn((50, 16), generator=g)
    y = torch.tanh(torch.randn((50, 16), generator=g))
    x = torch.randn((50, OBS), generator=g).bfloat16()
    p0, y0 = p.clone(), y.clone()
    d, db, hf, xf = K.trunk_backward(p, y, x)
    assert d is p and hf is y
    pb = p0.to(torch.bfloat16).double()
    want = pb * (1 - y0.double() ** 2)
    # float32's rounding of y * y, then of the product
    assert bool(((d.double() - want).abs() <= 2 ** -22 * pb.abs()).all())
    torch.testing.assert_close(db, d.sum(0), rtol=0.0, atol=0.0)
    assert torch.equal(hf, y0.to(torch.bfloat16).float())
    assert torch.equal(xf, x.float())
    assert K.trunk_backward(p, y)[3] is None


def test_trunk_backward_runs_once():
    """The backward writes over its saved activations, so a second
    backward through the same graph raises instead of reading them."""
    policy = _policy(16, torch.device("cpu"))
    obs = torch.randn((9, OBS)).bfloat16()
    mu, _, value = ppo._apply_trunk(policy, obs)
    loss = mu.sum() + value.sum()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="runs once"):
        loss.backward()


@pytest.mark.parametrize("H,ok", [(256, True), (32, True), (64, True),
                                  (8, True), (2048, True), (12, False),
                                  (4, False), (2056, False)])
def test_trunk_width_check(H, ok):
    """Every width the card's trainers and tests use (256, 32, 64) is
    taken; a width that is no multiple of the passes' 8-element vectors,
    or beyond a CTA's 256 threads of them, raises."""
    bf = torch.bfloat16
    args = (torch.zeros((5, OBS), dtype=bf), torch.zeros((H, OBS), dtype=bf),
            torch.zeros(H), torch.zeros((H, H), dtype=bf), torch.zeros(H),
            torch.zeros((ACT + 1, H), dtype=bf))
    if ok:
        K.check_trunk(*args)
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            K.check_trunk(*args)


def test_trunk_check_refuses_mismatched_operands():
    bf = torch.bfloat16
    good = [torch.zeros((5, OBS), dtype=bf), torch.zeros((32, OBS), dtype=bf),
            torch.zeros(32), torch.zeros((32, 32), dtype=bf), torch.zeros(32),
            torch.zeros((ACT + 1, 32), dtype=bf)]
    K.check_trunk(*good)
    for i, bad in ((0, good[0].float()), (1, good[1][:, :-1]),
                   (2, torch.zeros(31)), (3, good[3].float()),
                   (0, good[0][:0])):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            K.check_trunk(*args)


def test_bf16_matmul_plain_version():
    """On the CPU the trunk's GEMM is the float32 product of the same bf16
    values (the card's bf16 GEMM with float32 output differs from it only
    by the order of the sums)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((40, OBS), generator=g).bfloat16()
    w = torch.randn((24, OBS), generator=g).bfloat16()
    out = K.bf16_matmul(x, w)
    assert out.dtype == torch.float32 and out.shape == (40, 24)
    assert torch.equal(out, x.float() @ w.float().t())


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _pass_inputs(rows, H, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = 2.0 * torch.randn((rows, H), generator=g, device=dev)
    bias = torch.randn((H,), generator=g, device=dev)
    # products over three decades, some on bf16 ties' neighbours
    p = torch.randn((rows, H), generator=g, device=dev) * torch.exp(
        3.0 * torch.randn((rows, H), generator=g, device=dev))
    y = torch.tanh(2.0 * torch.randn((rows, H), generator=g, device=dev))
    # x misaligned (a view one element in) where the rows are odd: the
    # copy's element-wise path
    flat = torch.randn((rows * OBS + 1,), generator=g,
                       device=dev).bfloat16()
    x = flat[rows % 2:rows % 2 + rows * OBS].view(rows, OBS)
    return a, bias, p, y, x


@pytest.mark.gpu
@pytest.mark.parametrize("rows,H", [(24576, 256), (24577, 256), (1000, 64),
                                    (37, 32), (3, 2048)])
def test_trunk_kernels_match_plain(cuda, rows, H):
    """The forward pass (with and without y) and the backward pass
    against their plain versions on the same card tensors: y, h, d, hf
    and the copy of x bit-equal; the bias sums within 1e-5 of each
    column's sum of |d|."""
    a, bias, p, y, x = _pass_inputs(rows, H, cuda, rows + H)
    before = K.ppo_trunk.launches
    for keep in (True, False):
        (y_k, h_k), (y_r, h_r) = (K.trunk_forward(a.clone(), bias, keep),
                                  K.trunk_forward_ref(a.clone(), bias, keep))
        assert torch.equal(h_k, h_r)
        if keep:
            assert torch.equal(y_k, y_r)
        else:
            assert y_k is None and y_r is None
    got = K.trunk_backward(p.clone(), y.clone(), x)
    want = K.trunk_backward_ref(p.clone(), y.clone(), x)
    torch.cuda.synchronize()
    assert K.ppo_trunk.launches - before == 3
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i]), i
    scale = want[0].abs().sum(0)
    assert bool(((got[1] - want[1]).abs() <= 1e-5 * scale).all())


@pytest.mark.gpu
def test_trunk_kernels_are_bit_reproducible(cuda):
    """Two calls on the same inputs give the same bits: no atomics (the
    captured and eager train steps are compared bit for bit)."""
    a, bias, p, y, x = _pass_inputs(24576, 256, cuda, 5)
    first = [K.trunk_forward(a.clone(), bias, True),
             K.trunk_backward(p.clone(), y.clone(), x)]
    second = [K.trunk_forward(a.clone(), bias, True),
              K.trunk_backward(p.clone(), y.clone(), x)]
    for u, v in zip(first, second):
        for s, t in zip(u, v):
            assert torch.equal(s, t)


class _ChainMatmul(torch.autograd.Function):
    """The bf16 GEMM of the autograd chain the trunk's passes replaced:
    x bf16 @ w.T bf16 -> float32 forward; float32 products backward (each
    has a float32 cotangent operand), returned as bf16 gradients, as a
    bf16 cast's backward rounds them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.float()).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            gw = (g.t() @ x.float()).to(torch.bfloat16)
        return gx, gw


def _chain_apply(policy, obs):
    """The autograd chain the trunk's passes replace: bf16 GEMMs with
    float32 output (:class:`_ChainMatmul`) with PyTorch's bias adds, tanh
    and casts."""
    bf = torch.bfloat16
    mm = _ChainMatmul.apply
    h = torch.tanh(mm(obs, policy.trunk1.weight.to(bf)) + policy.trunk1.bias)
    h = torch.tanh(mm(h.to(bf), policy.trunk2.weight.to(bf))
                   + policy.trunk2.bias)
    heads = torch.cat([policy.mu.weight, policy.value.weight]).to(bf)
    out = mm(h.to(bf), heads) + torch.cat([policy.mu.bias, policy.value.bias])
    return out[..., :ACT], policy.log_std, out[..., ACT]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,H", [(24576, 256), (1000, 64), (37, 32)])
def test_trunk_matches_the_autograd_chain(cuda, rows, H):
    """``policy_apply_bf16`` through the passes against the chain it
    replaced, on the same card: mu, value and every weight gradient
    bit-equal (the same GEMMs on the same bits), the bias gradients to
    the float32 rounding of another summation order."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    policy = _policy(H, cuda, seed=rows)
    obs = torch.randn((rows, OBS), generator=g, device=cuda).bfloat16()
    cot_mu = torch.randn((rows, ACT), generator=g, device=cuda)
    cot_v = torch.randn((rows,), generator=g, device=cuda)
    mu, value, grads = _run(ppo.policy_apply_bf16, policy, obs, cot_mu,
                            cot_v)
    mu_c, value_c, grads_c = _run(_chain_apply, policy, obs, cot_mu, cot_v)
    assert torch.equal(mu, mu_c) and torch.equal(value, value_c)
    for name, want in grads_c.items():
        if name.endswith("weight") or name in ("mu.bias", "value.bias"):
            assert torch.equal(grads[name], want), name
        else:
            torch.testing.assert_close(grads[name], want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
    with torch.no_grad():
        scored = ppo.policy_apply_bf16(policy, obs)
        chained = _chain_apply(policy, obs)
    assert all(torch.equal(a, b) for a, b in zip(scored, chained))


@pytest.mark.gpu
def test_trunk_raises_on_the_card_for_a_width_it_cannot_take(cuda):
    policy = _policy(12, cuda)
    obs = torch.zeros((8, OBS), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        ppo.policy_apply_bf16(policy, obs)


@pytest.mark.gpu
def test_fused_trunk_launches_per_train_step(cuda):
    """Under a trace recording, one captured train step of the fused EV
    trainer after the first launches the passes four times a minibatch
    (two forward, two backward) and twice for the scoring."""
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.core import trace
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    env, p = make("evcharging", device=cuda)
    cfg = PPOConfig(num_envs=64, hidden=64, minibatches=4, epochs=2,
                    obs_bf16=True)
    init_state, step = make_train_step(env, p, cfg)
    gen = torch.Generator(device=cuda).manual_seed(5)
    carry = init_state(gen)
    carry, _ = step(carry, gen)
    with trace.recording() as rec:
        carry, _ = step(carry, gen)
    launches = rec.snapshot()["launches"]["ppo_trunk"]
    assert launches == 4 * cfg.epochs * cfg.minibatches + 2
