"""The whole paired-form PDHG solve in one launch: the hand-written Hopper
kernel of ``csrc/lp_solve.cu``, and its plain PyTorch version.

``pdhg_solve_paired`` replaces ``sustaingym_tpu/ops/pallas/lp_solve.py::
pdhg_solve_paired``: every iteration of ``ops/lp.py::solve_lp`` for an
operator with equality rows A and a paired block S (no residual G rows),
relax 1, bf16 matrix-product operands and float32 sums, from a warm start.
What bounds it and how it is laid out is in the ``.cu`` file.

Per-env arrays are env-major (B, rows) float32 and B is any size: the TPU
kernel's 128-lane groups, 8-row padding and transposes have no counterpart.

``iters`` is one budget for every env (an int) or a (B,) int32 tensor on
the device, one budget an env: each env stops after its own, as
``solve_lp``'s (B,) budget does, and ends with the bits of a launch at its
own budget. The kernel reads the budgets on the device, so a CUDA graph
captures the launch (the market's generic step).

A CUDA ``c`` launches the kernel (its count is
``pdhg_solve_paired.launches``); a CPU one runs ``pdhg_solve_paired_ref``,
a thin adapter onto ``solve_lp`` with that math: the oracle for the
kernel, equal to it up to float reassociation in the products.
"""
from __future__ import annotations

import torch

from ..lp import LPOperator, LPSolution, solve_lp
from ...core.graph import count_launches
from ...core.struct import dataclass, replace
from .wrap import (I, P, PI, bind, check, ctas_per_sm, on_card, pad16, ptr,
                   raise_on)

__all__ = ["PDHGOperands", "pack_pdhg_operands", "pdhg_solve_paired",
           "pdhg_solve_paired_ref", "pdhg_occupancy"]

# K, tau, sig, c, b, hp, hm, ub | ub_stride | x0, y0, zp0, zm0 |
# n, me, ms, B, iters | budget, x, y, zp, zm, stream
_SIGNATURES = {"pdhg_solve_paired_launch":
               [P] * 8 + [I] + [P] * 4 + [I] * 5 + [P] * 6,
               "pdhg_solve_paired_ctas_per_sm": [I, I, I, PI, PI]}


@dataclass
class PDHGOperands:
    """An ``LPOperator`` (me equalities + paired S block, mg == 0) with the
    kernel's operands: K = [A; S] in bf16, its tile-padded copy and the
    step vectors."""
    op: LPOperator
    K: torch.Tensor      # (me + ms, n) bfloat16
    Kp: torch.Tensor     # (pad16(me) + pad16(ms), pad16(n)) bfloat16
    tau: torch.Tensor    # (n,) float32
    sig: torch.Tensor    # (me + ms,) float32: [sigma_a, sigma_s]


def pack_pdhg_operands(op: LPOperator) -> PDHGOperands:
    """The kernel's operands of ``op`` on its device. ``Kp`` is K with the
    A rows and the S rows each zero-padded to a multiple of 16 rows and
    the columns to a multiple of 16: the mma tiles of ``csrc/lp_solve.cu``,
    with the A' and S' sums of the gradient in tiles of their own."""
    if op.mg != 0:
        raise ValueError("pdhg_solve_paired covers the paired form only "
                         f"(no residual G rows); the operator has {op.mg}")
    K = torch.cat([op.A, op.S]).to(torch.bfloat16).contiguous()
    n, me, ms = op.n, op.me, op.ms
    Kp = torch.zeros((pad16(me) + pad16(ms), pad16(n)), dtype=torch.bfloat16,
                     device=K.device)
    Kp[:me, :n] = K[:me]
    Kp[pad16(me):pad16(me) + ms, :n] = K[me:]
    return PDHGOperands(
        op=op, K=K, Kp=Kp, tau=op.tau.float().contiguous(),
        sig=torch.cat([op.sigma_a, op.sigma_s]).float().contiguous())


def pdhg_solve_paired_ref(kops: PDHGOperands, c, b, hp, hm, ub, x0, y0, zp0,
                          zm0, iters: int | torch.Tensor):
    """Plain version of :func:`pdhg_solve_paired`: ``solve_lp`` with bf16
    products, relax 1 and separate A and S blocks; a (B,) ``iters`` goes to
    ``solve_lp`` as its per-env budget."""
    op = replace(kops.op, matmul_dtype=torch.bfloat16, relax=1.0,
                 merge_blocks=False)
    sol = solve_lp(op, c, b, torch.cat([hp, hm], -1), torch.zeros_like(c),
                   ub, init=LPSolution(x=x0, y=y0,
                                       z=torch.cat([zp0, zm0], -1)),
                   iters=iters)
    ms = op.ms
    return sol.x, sol.y, sol.z[:, :ms], sol.z[:, ms:]


def pdhg_solve_paired(kops: PDHGOperands, c, b, hp, hm, ub, x0, y0, zp0,
                      zm0, iters: int | torch.Tensor):
    """``iters`` PDHG iterations for B envs: ``c``, ``x0`` (B, n); ``b``,
    ``y0`` (B, me); ``hp``, ``hm``, ``zp0``, ``zm0`` (B, ms); ``ub`` (n,) or
    (B, n); lower bounds 0. ``iters``: an int, or (B,) int32 per-env
    budgets on ``c``'s device (negative ones run 0 iterations; their values
    are read on the device only). Returns (x, y, zp, zm), env-major
    float32."""
    if not on_card(c, "pdhg_solve_paired"):
        return pdhg_solve_paired_ref(kops, c, b, hp, hm, ub, x0, y0, zp0,
                                     zm0, iters)
    op, dev = kops.op, c.device
    n, me, ms = op.n, op.me, op.ms
    B = c.shape[0]
    f32 = torch.float32
    check("Kp", kops.Kp, torch.bfloat16, (pad16(me) + pad16(ms), pad16(n)),
          dev)
    check("tau", kops.tau, f32, (n,), dev)
    check("sig", kops.sig, f32, (me + ms,), dev)
    for name, x, rows in (("c", c, n), ("x0", x0, n), ("b", b, me),
                          ("y0", y0, me), ("hp", hp, ms), ("hm", hm, ms),
                          ("zp0", zp0, ms), ("zm0", zm0, ms)):
        check(name, x, f32, (B, rows), dev)
    if ub.ndim == 1:
        check("ub", ub, f32, (n,), dev)
    else:
        check("ub", ub, f32, (B, n), dev)
    budget = None
    if isinstance(iters, torch.Tensor):
        check("iters", iters, torch.int32, (B,), dev)
        budget, iters = iters, 0
    elif int(iters) < 0:
        raise ValueError(f"pdhg_solve_paired: iters {iters} < 0")
    x = torch.empty((B, n), dtype=f32, device=dev)
    y = torch.empty((B, me), dtype=f32, device=dev)
    zp = torch.empty((B, ms), dtype=f32, device=dev)
    zm = torch.empty((B, ms), dtype=f32, device=dev)
    if B == 0:
        return x, y, zp, zm
    with torch.cuda.device(dev):
        err = bind("lp_solve", _SIGNATURES).pdhg_solve_paired_launch(
            kops.Kp.data_ptr(), kops.tau.data_ptr(), kops.sig.data_ptr(),
            c.data_ptr(), b.data_ptr(), hp.data_ptr(), hm.data_ptr(),
            ub.data_ptr(), 0 if ub.ndim == 1 else n, x0.data_ptr(),
            y0.data_ptr(), zp0.data_ptr(), zm0.data_ptr(), n, me, ms, B,
            int(iters), ptr(budget), x.data_ptr(), y.data_ptr(),
            zp.data_ptr(), zm.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "pdhg_solve_paired")
    pdhg_solve_paired.launches += 1
    return x, y, zp, zm


count_launches(pdhg_solve_paired)


def pdhg_occupancy(op: LPOperator) -> tuple[int, int]:
    """(CTAs resident per SM, envs per CTA) of the kernel instance that
    ``op``'s shape takes, on the current card."""
    return ctas_per_sm(bind("lp_solve", _SIGNATURES)
                       .pdhg_solve_paired_ctas_per_sm, op.n, op.me, op.ms)
