"""The clipped-PPO minibatch loss of a diagonal-Gaussian head and its
gradient in one pass: the hand-written kernel of ``csrc/ppo_loss.cu``, its
plain PyTorch version, and the autograd binding that
``parallel/ppo.py::loss_fn`` uses on the card.

``ppo_gauss_loss(mu, log_std, value, u, logp_old, adv, ret, clip_eps,
vf_coef, ent_coef)`` returns ``(loss, pg, vf, ent, d_mu, d_value,
d_log_std)``: what ``loss_fn`` computes for a Gaussian head without a mask
(advantages normalised by their mean and population std, the clipped
ratio, the value loss, the entropy), and the gradient of ``loss`` with
respect to ``mu``, ``value`` and ``log_std`` by autograd's rules (a tie of
the minimum splits its gradient in half, the clamp's bounds pass it). A
CUDA ``mu`` launches the kernel (its count is ``ppo_gauss_loss.launches``);
a CPU one runs the plain version, the same closed forms in PyTorch, in the
inputs' dtype. The kernel sums each row's log-prob with a compensated sum,
so it is closer to the float64 result than the plain float32 version, and
equal to it only up to rounding.

:func:`fused_ppo_loss` is the differentiable form: ``(loss, pg, vf, ent)``
whose backward returns the saved gradients times the incoming one. Where
``mu`` and ``value`` are the two parts of one (rows, A + 1) head product
(:func:`head_of`; ``policy_apply_bf16`` gives them so on the card), the
kernel reads them in place and writes the gradient of that product whole.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...core.graph import count_launches
from .wrap import F, I, P, bind, check, on_card, raise_on

__all__ = ["ppo_gauss_loss", "ppo_gauss_loss_ref", "fused_ppo_loss",
           "check_head", "head_of", "MAX_ACT_DIM", "MAX_ROWS"]

L = ctypes.c_int64
_SIGNATURES = {
    "ppo_gauss_loss_launch": [P, L, P, P, L, P, P, P, P, I, I, F, F, F, F,
                              P, L, P, L, P, P, P],
    "ppo_gauss_loss_workspace": [I, I]}
# the kernel's shared-memory columns, and float32 row counts kept exact
MAX_ACT_DIM = 1024
MAX_ROWS = 2 ** 24 - 1
_LOG_2PI = math.log(2 * math.pi)
_ENT_TERM = 0.5 * math.log(2 * math.pi * math.e)


def ppo_gauss_loss_ref(mu, log_std, value, u, logp_old, adv, ret,
                       clip_eps: float, vf_coef: float, ent_coef: float):
    """Plain version: the loss head's forward in ``loss_fn``'s own
    operations, and its gradient in closed form."""
    n = mu.shape[0]
    var = torch.exp(2 * log_std)
    d = u - mu
    logp = torch.sum(-0.5 * (d ** 2 / var + 2 * log_std + _LOG_2PI), -1)
    a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - logp_old)
    lo, hi = 1 - clip_eps, 1 + clip_eps
    s1, s2 = ratio * a, torch.clamp(ratio, lo, hi) * a
    pg = -torch.mean(torch.minimum(s1, s2))
    vf = 0.5 * torch.mean((value - ret) ** 2)
    ent = torch.sum(log_std + _ENT_TERM)
    loss = pg + vf_coef * vf - ent_coef * ent
    # d min / d s1 and d s2 (a tie split in half), the clamp's inclusive
    # mask on s2's share, then through the exp: d min / d logp
    half = torch.where(s1 == s2, 0.5, 1.0).to(s1.dtype)
    w1 = torch.where(s1 <= s2, half, 0.0)
    w2 = torch.where(s2 <= s1, half, 0.0) * ((ratio >= lo) & (ratio <= hi))
    dlogp = -(ratio * a * (w1 + w2)) / n
    q = d / var
    d_mu = dlogp[:, None] * q
    d_log_std = -torch.sum((ratio * a * (w1 + w2))[:, None] * (d * q - 1),
                           0) / n - ent_coef
    d_value = vf_coef * (value - ret) / n
    if head_of(mu, value) is not None:
        d_head = torch.cat([d_mu, d_value[:, None]], 1)
        d_mu, d_value = d_head[:, :-1], d_head[:, -1]
    return loss, pg, vf, ent, d_mu, d_value, d_log_std


def head_of(mu, value):
    """The (rows, A + 1) tensor whose first A columns are ``mu`` and whose
    last is ``value`` (views of it, as ``policy_apply_bf16`` gives them on
    the card), or None."""
    head = mu._base
    if head is None or value._base is not head or head.ndim != 2 \
            or mu.ndim != 2 or value.ndim != 1:
        return None
    rows, A = mu.shape
    if tuple(head.shape) != (rows, A + 1) or not head.is_contiguous() \
            or mu.stride() != (A + 1, 1) or value.stride() != (A + 1,) \
            or mu.data_ptr() != head.data_ptr() \
            or value.data_ptr() != head.data_ptr() + A * head.element_size():
        return None
    return head


def ppo_gauss_loss(mu, log_std, value, u, logp_old, adv, ret,
                   clip_eps: float, vf_coef: float, ent_coef: float):
    """mu (rows, A) float32 with unit column stride and any row stride,
    log_std (A,), value (rows,) with any stride, u (rows, A), logp_old,
    adv, ret (rows,) -> (loss, pg, vf, ent, d_mu (rows, A), d_value
    (rows,), d_log_std (A,)). Where ``mu`` and ``value`` are the parts of
    one head product (:func:`head_of`), ``d_mu`` and ``d_value`` are the
    same parts of one gradient of it (their ``_base``)."""
    if not on_card(mu, "ppo_gauss_loss"):
        return ppo_gauss_loss_ref(mu, log_std, value, u, logp_old, adv, ret,
                                  clip_eps, vf_coef, ent_coef)
    dev = mu.device
    check_head(mu, log_std, value)
    rows, A = mu.shape
    check("log_std", log_std, torch.float32, (A,), dev)
    check("u", u, torch.float32, (rows, A), dev)
    for name, x in (("logp_old", logp_old), ("adv", adv), ("ret", ret)):
        check(name, x, torch.float32, (rows,), dev)
    lib = bind("ppo_loss", _SIGNATURES)
    if head_of(mu, value) is None:
        d_mu = torch.empty((rows, A), device=dev)
        d_value = torch.empty((rows,), device=dev)
    else:
        d_head = torch.empty((rows, A + 1), device=dev)
        d_mu, d_value = d_head[:, :A], d_head[:, A]
    work = torch.empty((lib.ppo_gauss_loss_workspace(rows, A),), device=dev)
    out = torch.empty((4 + A,), device=dev)
    with torch.cuda.device(dev):
        err = lib.ppo_gauss_loss_launch(
            mu.data_ptr(), mu.stride(0), log_std.data_ptr(),
            value.data_ptr(), value.stride(0), u.data_ptr(),
            logp_old.data_ptr(), adv.data_ptr(), ret.data_ptr(), rows, A,
            1 - clip_eps, 1 + clip_eps, vf_coef, ent_coef, d_mu.data_ptr(),
            d_mu.stride(0), d_value.data_ptr(), d_value.stride(0),
            work.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "ppo_gauss_loss")
    ppo_gauss_loss.launches += 1
    return out[0], out[1], out[2], out[3], d_mu, d_value, out[4:]


count_launches(ppo_gauss_loss)


def check_head(mu, log_std, value):
    """Raises ValueError unless the kernel takes these head outputs:
    float32 (rows, A) ``mu`` with unit column stride, 0 < rows <=
    ``MAX_ROWS``, 0 < A <= ``MAX_ACT_DIM``, float32 (A,) ``log_std`` and
    (rows,) ``value``, all on one device."""
    if not (mu.dtype == torch.float32 and mu.ndim == 2
            and 0 < mu.shape[0] <= MAX_ROWS
            and 0 < mu.shape[1] <= MAX_ACT_DIM
            and (mu.shape[1] == 1 or mu.stride(1) == 1)
            and log_std.shape == mu.shape[1:]
            and log_std.dtype == torch.float32
            and value.shape == mu.shape[:1] and value.dtype == torch.float32
            and log_std.device == mu.device == value.device):
        raise ValueError(
            f"ppo_gauss_loss: mu {mu.dtype} {tuple(mu.shape)} strides "
            f"{mu.stride()}, log_std {log_std.dtype} "
            f"{tuple(log_std.shape)}, value {value.dtype} "
            f"{tuple(value.shape)}: float32 (rows, A) with unit column "
            f"stride, (A,) and (rows,) on one device expected, rows <= "
            f"{MAX_ROWS}, A <= {MAX_ACT_DIM}")


class _FusedPPOLoss(torch.autograd.Function):
    """(loss, pg, vf, ent) from :func:`ppo_gauss_loss` of ``x``, either
    ``mu`` (with ``value`` given) or, with ``value`` None, the (rows,
    A + 1) head product whose parts are ``mu`` and ``value``. The
    gradients it computed are saved, and the backward scales them by the
    loss's incoming gradient (pg, vf and ent carry none); a head product
    gets its gradient whole, with no slicing in between."""

    @staticmethod
    def forward(ctx, x, log_std, value, u, logp_old, adv, ret, clip_eps,
                vf_coef, ent_coef):
        whole = value is None
        mu, value = (x[:, :-1], x[:, -1]) if whole else (x, value)
        loss, pg, vf, ent, d_mu, d_value, d_log_std = ppo_gauss_loss(
            mu, log_std, value, u, logp_old, adv, ret, clip_eps, vf_coef,
            ent_coef)
        ctx.whole = whole
        ctx.save_for_backward(d_mu._base if whole else d_mu, d_log_std,
                              d_value)
        ctx.mark_non_differentiable(pg, vf, ent)
        ctx.set_materialize_grads(False)
        return loss, pg, vf, ent

    @staticmethod
    def backward(ctx, g, *_):
        if g is None:
            return (None,) * 10
        d_x, d_log_std, d_value = ctx.saved_tensors
        return (d_x * g, d_log_std * g,
                None if ctx.whole else d_value * g) + (None,) * 7


def fused_ppo_loss(mu, log_std, value, u, logp_old, adv, ret,
                   clip_eps: float, vf_coef: float, ent_coef: float):
    """Differentiable (loss, pg, vf, ent) of :func:`ppo_gauss_loss` with
    respect to ``mu``, ``log_std`` and ``value``, or to the head product
    whose parts they are (:func:`head_of`)."""
    head = head_of(mu, value)
    if head is not None:
        return _FusedPPOLoss.apply(head, log_std, None, u, logp_old, adv,
                                   ret, clip_eps, vf_coef, ent_coef)
    return _FusedPPOLoss.apply(mu, log_std, value, u, logp_old, adv, ret,
                               clip_eps, vf_coef, ent_coef)
