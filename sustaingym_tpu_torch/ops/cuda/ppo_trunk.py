"""The elementwise glue of the PPO actor-critic's bf16 trunk between its
GEMMs, forward and backward: the hand-written passes of
``csrc/ppo_trunk.cu``, their plain PyTorch versions, and the autograd
binding that ``parallel/ppo.py::policy_apply_bf16`` uses on the card.

- :func:`trunk_forward` (a hidden layer's forward pass): ``y = tanh(a +
  b)`` of the (rows, H) float32 GEMM output ``a`` and the bias, and ``h``,
  ``y`` rounded to bf16 for the next GEMM; with ``keep`` ``y`` is written
  over ``a`` and returned, else it is not stored.
- :func:`trunk_backward` (a hidden layer's backward pass): from the
  float32 product ``p = g @ W`` of the layer above and the saved ``y``,
  ``d = float(bf16(p)) * (1 - y * y)`` (the bf16 cast of the gradient, its
  backward, then tanh's) written over ``p``, ``hf = float(bf16(y))`` (the
  float32 copy of the layer's bf16 output) written over ``y``, the bias
  gradient ``db`` (the column sums of ``d``) and, for a bf16 ``x``, its
  float32 copy.
- :func:`ppo_trunk`: ``bf16(tanh(bf16(tanh(x @ w1.T + b1)) @ w2.T + b2))
  @ wh.T`` with float32 products of the bf16 operands, differentiable with
  respect to the weights and biases (:class:`_Trunk`). The backward's
  products stay float32 (each has a float32 cotangent operand) and the
  weight gradients are rounded to bf16, as a bf16 cast's backward rounds
  them; the float32 copies that the weight gradients' products take come
  from the backward passes, so no cast kernel runs. With grad off (or
  nothing to differentiate) the forward passes store no ``y``.
- :func:`bf16_matmul`: ``x @ w.T`` of bf16 tensors with float32 output,
  the trunk's GEMM (forward only).

A CUDA tensor launches the kernels (``ppo_trunk.launches`` counts the
passes: one a hidden layer forward, one backward, whose bias sums take a
second, small kernel); a CPU tensor runs the plain versions, whose GEMMs
are the float32 products of the same bf16 values. On the card ``y``, ``h``,
``d`` and ``hf`` equal PyTorch's chain (``tanh``, ``.to(bf16)``,
``tanh_backward``) bit for bit; the bias gradient is summed in another
order than ``sum(0)``.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from ...core.graph import count_launches
from .wrap import I, P, bind, check, on_card, raise_on

__all__ = ["ppo_trunk", "trunk_forward", "trunk_forward_ref",
           "trunk_backward", "trunk_backward_ref", "check_trunk",
           "bf16_matmul", "MAX_HIDDEN"]

L = ctypes.c_int64
_SIGNATURES = {
    "ppo_trunk_forward_launch": [P, P, P, L, I, I, I, P],
    "ppo_trunk_backward_launch": [P, P, L, I, P, P, L, P, P, I, P],
    "ppo_trunk_workspace": [I, I]}
# a thread takes 8 elements of a row, a CTA at most 256 threads
MAX_HIDDEN = 2048
_SMS: dict[int, int] = {}
# the backward's partial rows of the bias sums, one buffer a (card, H),
# made by the first call (a capture's warm-up runs before the capture, so
# it never lands in a graph's pool): each call's two launches write then
# read it in stream order, and the trainers run the trunk on one stream at
# a time (a capture's side stream is joined before and after its warm-up)
_WORK: dict[tuple[int, int], torch.Tensor] = {}


def _lib():
    return bind("ppo_trunk", _SIGNATURES)


def _card(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _sms(idx: int) -> int:
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _on(idx: int):
    """The device a launch needs current: a context only where another
    one is."""
    if idx == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def _work(idx: int, H: int) -> torch.Tensor:
    if (idx, H) not in _WORK:
        n = _lib().ppo_trunk_workspace(H, _sms(idx))
        _WORK[idx, H] = torch.empty((n,), device=torch.device("cuda", idx))
    return _WORK[idx, H]


def _width(H: int) -> bool:
    return 8 <= H <= MAX_HIDDEN and H % 8 == 0


def trunk_forward_ref(a: torch.Tensor, bias: torch.Tensor, keep: bool):
    """Plain version of :func:`trunk_forward`: PyTorch's bias add, tanh
    and bf16 cast (in place on ``a`` with ``keep``)."""
    y = a.add_(bias).tanh_() if keep else torch.tanh(a + bias)
    return (y if keep else None), y.to(torch.bfloat16)


def trunk_forward(a: torch.Tensor, bias: torch.Tensor, keep: bool):
    """a (rows, H) float32 contiguous, bias (H,) float32 -> (y or None,
    h (rows, H) bf16); ``keep`` writes ``y`` over ``a`` and returns it."""
    if not on_card(a, "ppo_trunk"):
        return trunk_forward_ref(a, bias, keep)
    dev = a.device
    rows, H = a.shape
    _check_pass(a, H)
    check("bias", bias, torch.float32, (H,), dev)
    h = torch.empty((rows, H), dtype=torch.bfloat16, device=dev)
    idx = _card(dev)
    with _on(idx):
        err = _lib().ppo_trunk_forward_launch(
            a.data_ptr(), bias.data_ptr(), h.data_ptr(), rows, H, int(keep),
            _sms(idx), torch.cuda.current_stream(idx).cuda_stream)
    raise_on(err, "ppo_trunk forward")
    ppo_trunk.launches += 1
    return (a if keep else None), h


def trunk_backward_ref(p: torch.Tensor, y: torch.Tensor,
                       x: torch.Tensor | None = None):
    """Plain version of :func:`trunk_backward`: the bf16 cast and its
    backward, PyTorch's ``tanh_backward``, ``sum(0)``, and the casts, with
    ``d`` and ``hf`` copied over ``p`` and ``y``."""
    d = p.copy_(torch.ops.aten.tanh_backward(p.to(torch.bfloat16).float(),
                                             y))
    hf = y.copy_(y.to(torch.bfloat16).float())
    return d, d.sum(0), hf, None if x is None else x.float()


def trunk_backward(p: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor | None = None):
    """p, y (rows, H) float32 contiguous -> (d, db (H,), hf, xf): ``d``
    written over ``p``, ``hf`` over ``y``; ``xf`` the float32 copy of the
    contiguous bf16 ``x``, or None without one."""
    if not on_card(p, "ppo_trunk"):
        return trunk_backward_ref(p, y, x)
    dev = p.device
    rows, H = p.shape
    _check_pass(p, H)
    check("y", y, torch.float32, (rows, H), dev)
    if y.data_ptr() % 16:
        raise ValueError("ppo_trunk: y must be 16-byte aligned")
    xf = None
    if x is not None:
        check("x", x, torch.bfloat16, x.shape, dev)
        xf = torch.empty(x.shape, device=dev)
    idx = _card(dev)
    work = _work(idx, H)
    db = torch.empty((H,), device=dev)
    with _on(idx):
        err = _lib().ppo_trunk_backward_launch(
            p.data_ptr(), y.data_ptr(), rows, H,
            None if x is None else x.data_ptr(),
            None if xf is None else xf.data_ptr(),
            0 if x is None else x.numel(), work.data_ptr(), db.data_ptr(),
            _sms(idx), torch.cuda.current_stream(idx).cuda_stream)
    raise_on(err, "ppo_trunk backward")
    ppo_trunk.launches += 1
    return p, db, y, xf


def _check_pass(a: torch.Tensor, H: int):
    if not _width(H):
        raise ValueError(f"ppo_trunk: hidden width {H}: a multiple of 8 "
                         f"from 8 to {MAX_HIDDEN} expected")
    check("a", a, torch.float32, (a.shape[0], H), a.device)
    if a.shape[0] == 0 or a.data_ptr() % 16:
        raise ValueError(f"ppo_trunk: {tuple(a.shape)} at {a.data_ptr()}: "
                         f"rows > 0, 16-byte aligned expected")


def check_trunk(x, w1, b1, w2, b2, wh):
    """Raises ValueError unless the trunk takes these operands: bf16 x
    (rows, D) with rows > 0, bf16 weights w1 (H, D), w2 (H, H), wh (M, H),
    float32 biases (H,), all on one device, H a multiple of 8 from 8 to
    ``MAX_HIDDEN`` (the passes' 16-byte vectors)."""
    H = w1.shape[0] if w1.ndim == 2 else -1
    bf = torch.bfloat16
    ok = (x.ndim == 2 and x.shape[0] > 0 and x.dtype == bf
          and w1.ndim == 2 and w1.shape[1] == x.shape[1] and w1.dtype == bf
          and tuple(w2.shape) == (H, H) and w2.dtype == bf
          and wh.ndim == 2 and wh.shape[1] == H and wh.dtype == bf
          and all(tuple(b.shape) == (H,) and b.dtype == torch.float32
                  for b in (b1, b2))
          and len({t.device for t in (x, w1, b1, w2, b2, wh)}) == 1)
    if not ok or not _width(H):
        raise ValueError(
            f"ppo_trunk: x {x.dtype} {tuple(x.shape)}, w1 {w1.dtype} "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {w2.dtype} "
            f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}, wh {wh.dtype} "
            f"{tuple(wh.shape)}: bf16 (rows, D), (H, D), (H, H), (M, H) and "
            f"float32 (H,) biases on one device expected, H a multiple of 8 "
            f"from 8 to {MAX_HIDDEN}")


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (rows, K) @ w (N, K).T of bf16 tensors with float32 output: one
    bf16 tensor-core GEMM on the card (``aten::mm.dtype``, the JAX
    package's bf16 ``einsum(..., preferred_element_type=float32)``), the
    float32 product of the same values on the CPU (its plain version).
    Products of bf16 values are exact in float32, so the two differ only
    by the order of the sums."""
    if x.device.type == "cuda":
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return x.float() @ w.float().t()


class _Trunk(torch.autograd.Function):
    """:func:`ppo_trunk` with its gradients. Saves ``x``, the weights and
    each layer's ``y``; the backward overwrites the ``y``s (with ``hf``),
    so it runs once (no ``retain_graph``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wh):
        y1, h1 = trunk_forward(bf16_matmul(x, w1), b1, keep=True)
        y2, h2 = trunk_forward(bf16_matmul(h1, w2), b2, keep=True)
        ctx.save_for_backward(x, w1, w2, wh, y1, y2)
        ctx.spent = False
        return bf16_matmul(h2, wh)

    @staticmethod
    def backward(ctx, g):
        if ctx.spent:
            raise RuntimeError("ppo_trunk: the backward overwrites its saved "
                               "activations and runs once")
        ctx.spent = True
        x, w1, w2, wh, y1, y2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        bf = torch.bfloat16
        d2, db2, hf2, _ = trunk_backward(g @ wh.float(), y2)
        gwh = (g.t() @ hf2).to(bf) if need[5] else None
        d1, db1, hf1, xf = trunk_backward(d2 @ w2.float(), y1,
                                          x if need[1] else None)
        gw2 = (d2.t() @ hf1).to(bf) if need[3] else None
        gw1 = (d1.t() @ xf).to(bf) if need[1] else None
        gx = (d1 @ w1.float()).to(bf) if need[0] else None
        return gx, gw1, db1, gw2, db2, gwh


def ppo_trunk(x, w1, b1, w2, b2, wh) -> torch.Tensor:
    """x (rows, D) bf16, w1 (H, D), w2 (H, H), wh (M, H) bf16, b1, b2 (H,)
    float32 -> the (rows, M) float32 product of the trunk's bf16 output
    with ``wh``; differentiable where grad is on and an operand requires
    it. A CUDA ``x`` launches the passes (:func:`check_trunk` raises for
    operands they cannot take)."""
    if on_card(x, "ppo_trunk"):
        check_trunk(x, w1, b1, w2, b2, wh)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2, wh)):
        return _Trunk.apply(x.contiguous(), w1, b1, w2, b2, wh)
    _, h1 = trunk_forward(bf16_matmul(x, w1), b1, keep=False)
    _, h2 = trunk_forward(bf16_matmul(h1, w2), b2, keep=False)
    return bf16_matmul(h2, wh)


count_launches(ppo_trunk)
