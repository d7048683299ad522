"""Batched fixed-iteration LP solver (PDHG / Chambolle-Pock) with duals:
the port of ``sustaingym_tpu.ops.lp``.

Built for the ElectricityMarketEnv SCED clearing solve: every 5-minute step
the market operator solves a multi-interval security-constrained economic
dispatch, and the clearing price is the dual of the power-balance
constraint. PDHG is pure matrix-vector products with a fixed iteration
count, so thousands of market instances clear in lockstep.

Problem form:
    minimize    c' x
    subject to  A x = b          (duals y -> prices)
                S x <= h_p  and  -S x <= h_m   (paired rows, optional)
                G x <= h_rest    (duals z >= 0)
                lb <= x <= ub

Iteration (with over-relaxation \\bar{x} and diagonal step sizes):
    x+ = clip(x - tau * (c + A' y + S'(z_p - z_m) + G' z), lb, ub)
    y+ = y + sigma_A * (A (2 x+ - x) - b)
    z+ = max(0, z + sigma * (rows (2 x+ - x) - h))

The paired block shares the matvec of the two-sided line-flow limits
|PTDF x| <= rating between its +S and -S rows; the iterates are those of
plain PDHG on the stacked [A; S; -S; G] up to float reassociation (same
preconditioner, same step sizes).

``matmul_dtype=torch.bfloat16`` rounds both operands of every matrix
product to bfloat16 and accumulates in float32, as the JAX package's
``dot_general(..., preferred_element_type=float32)``: computed here as a
float32 product of bf16-valued operands, which needs full float32 matmuls
on the card (TF32 off). Iterates and duals stay float32.

The whole-solve CUDA kernel ``ops/cuda/lp_solve.py::pdhg_solve_paired``
runs this iteration for the paired form with bf16 operands, relax 1 and no
G rows; :func:`solve_lp` is its plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.env import resolve_device
from ..core.struct import dataclass

__all__ = ["LPOperator", "make_lp_operator", "solve_lp", "LPSolution"]


@dataclass
class LPOperator:
    """Static problem structure with host-precomputed step sizes. The
    [A; S; G] blocks are kept separate, one matrix product each."""
    A: torch.Tensor        # (me, n) equality rows
    S: torch.Tensor        # (ms, n) paired block: +/- S x <= (h_p, h_m)
    G: torch.Tensor        # (mg, n) residual one-sided rows
    tau: torch.Tensor      # (n,) primal step
    sigma_a: torch.Tensor  # (me,) dual step (equalities)
    sigma_s: torch.Tensor  # (ms,) dual step (paired rows; same for +/-)
    sigma_g: torch.Tensor  # (mg,) dual step (residual rows)
    n: int
    me: int
    ms: int = 0            # paired rows (each yields +/-)
    mg: int = 0            # residual one-sided rows
    iters: int = 400
    # None -> float32 products; torch.bfloat16 -> bf16 operands, f32 sums
    matmul_dtype: torch.dtype | None = None
    # over-relaxation on the full PDHG operator; 1.0 = plain
    relax: float = 1.0
    # stacked [A; S] and its transpose for the merged-product iteration
    # (None when mg > 0 or either block is empty)
    AS: torch.Tensor | None = None
    AS_T: torch.Tensor | None = None
    merge_blocks: bool = False

    @property
    def mi(self) -> int:
        """Total inequality-dual length: [z_plus(ms), z_minus(ms), z(mg)]."""
        return 2 * self.ms + self.mg

    @property
    def device(self) -> torch.device:
        return self.tau.device


class LPSolution(NamedTuple):
    x: torch.Tensor   # primal
    y: torch.Tensor   # equality duals (prices)
    z: torch.Tensor   # inequality duals [z_plus(ms), z_minus(ms), z(mg)]


def make_lp_operator(A: np.ndarray, G: np.ndarray, iters: int = 400,
                     dtype=torch.float32, sym: np.ndarray | None = None,
                     matmul_dtype: torch.dtype | None = None,
                     relax: float = 1.0, precond_alpha: float = 1.0,
                     merge_blocks: bool = False,
                     device="cuda") -> LPOperator:
    """Builds the operator with diagonal (Pock-Chambolle) preconditioning,
    computed on the host in float64: tau_j = 1 / sum_i |K_ij|^(2-alpha),
    sigma_i = 1 / sum_j |K_ij|^alpha over the stacked K = [A; sym; -sym; G],
    then stored as ``dtype`` on ``device`` (the card unless the caller asks
    for the CPU).

    ``sym`` (ms, n), if given, adds the two-sided rows
    ±sym x <= (h_p, h_m); ``G`` keeps only the residual one-sided rows.
    """
    A = np.atleast_2d(np.asarray(A, np.float64))
    G = np.atleast_2d(np.asarray(G, np.float64))
    if G.size == 0:
        G = G.reshape(0, A.shape[1])
    S = (np.zeros((0, A.shape[1])) if sym is None
         else np.atleast_2d(np.asarray(sym, np.float64)))
    K = np.vstack([A, S, -S, G])
    a_exp = float(precond_alpha)
    col = (np.abs(K) ** (2.0 - a_exp)).sum(axis=0)
    tau = 1.0 / np.maximum(col, 1e-6)

    def row_sigma(mat):
        return 1.0 / np.maximum((np.abs(mat) ** a_exp).sum(axis=1), 1e-6)

    merged = bool(merge_blocks and A.shape[0] and S.shape[0]
                  and not G.shape[0])
    AS = np.vstack([A, S]) if merged else None
    dev = resolve_device(device)

    def put(x):
        return None if x is None else torch.as_tensor(
            np.ascontiguousarray(x), dtype=dtype, device=dev)

    return LPOperator(
        A=put(A), S=put(S), G=put(G), tau=put(tau),
        sigma_a=put(row_sigma(A)), sigma_s=put(row_sigma(S)),
        sigma_g=put(row_sigma(G)), AS=put(AS),
        AS_T=None if AS is None else put(AS.T),
        merge_blocks=merged, n=A.shape[1], me=A.shape[0], ms=S.shape[0],
        mg=G.shape[0], iters=int(iters), matmul_dtype=matmul_dtype,
        relax=float(relax))


def solve_lp(op: LPOperator, c: torch.Tensor, b: torch.Tensor,
             h: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
             init: LPSolution | None = None,
             iters: int | torch.Tensor | None = None,
             max_iters: int | None = None) -> LPSolution:
    """Solves a batch of LPs: ``c`` (B, n), ``b`` (B, me), ``h`` (B, mi)
    ordered [h_plus(ms), h_minus(ms), h_rest(mg)], bounds broadcasting
    against ``c``; the returned ``z`` follows ``h``'s ordering.

    ``init`` warm-starts the primal and dual iterates (x clipped to the
    bounds, z at 0). ``iters`` overrides ``op.iters``; a (B,) tensor gives
    each env its own budget: the solve runs the largest and freezes each
    env once its own budget is spent, as the JAX package's per-env while
    loops under ``vmap`` do. The largest is read on the host, which a CUDA
    graph capture cannot do: there the loop runs ``max_iters``, a bound
    of every budget that the caller gives (the frozen envs keep their
    values, so the result is the same)."""
    me, ms, mg = op.me, op.ms, op.mg
    if init is None:
        x = torch.minimum(torch.maximum(torch.zeros_like(c), lb), ub)
        y = torch.zeros_like(b)
        z = torch.zeros_like(h)
    else:
        x = torch.minimum(torch.maximum(init.x, lb), ub)
        y = init.y
        z = torch.clamp_min(init.z, 0.0)

    h_p, h_m, h_g = h[..., :ms], h[..., ms:2 * ms], h[..., 2 * ms:]
    if op.matmul_dtype is None:
        def rnd(u):
            return u
    else:
        def rnd(u):
            return u.to(op.matmul_dtype).to(u.dtype)

    def mats(*ms_):
        return [None if m is None else rnd(m) for m in ms_]

    A, S, G, AS, AS_T = mats(op.A, op.S, op.G, op.AS, op.AS_T)
    At, St, Gt = A.T, S.T, G.T
    rho = op.relax

    def body(x, y, zp, zm, zg):
        if op.merge_blocks:
            grad = c + rnd(torch.cat([y, zp - zm], -1)) @ AS
        else:
            grad = c
            if me:
                grad = grad + rnd(y) @ A
            if ms:
                grad = grad + rnd(zp - zm) @ S
            if mg:
                grad = grad + rnd(zg) @ G
        x_new = torch.minimum(torch.maximum(x - op.tau * grad, lb), ub)
        x_bar = 2.0 * x_new - x
        zg_new = zg
        if op.merge_blocks:
            t = rnd(x_bar) @ AS_T
            y_new = y + op.sigma_a * (t[..., :me] - b)
            s = t[..., me:]
            zp_new = torch.clamp_min(zp + op.sigma_s * (s - h_p), 0.0)
            zm_new = torch.clamp_min(zm + op.sigma_s * (-s - h_m), 0.0)
        else:
            y_new = y + op.sigma_a * (rnd(x_bar) @ At - b) if me else y
            if ms:
                s = rnd(x_bar) @ St            # shared +/- product
                zp_new = torch.clamp_min(zp + op.sigma_s * (s - h_p), 0.0)
                zm_new = torch.clamp_min(zm + op.sigma_s * (-s - h_m), 0.0)
            else:
                zp_new, zm_new = zp, zm
            if mg:
                zg_new = torch.clamp_min(
                    zg + op.sigma_g * (rnd(x_bar) @ Gt - h_g), 0.0)
        if rho != 1.0:
            # relaxed combination with a re-projection: a heuristic, not
            # the plain Krasnosel'skii-Mann iteration (as in the JAX
            # package, which keeps it off by default)
            x_new = x + rho * (x_new - x)
            y_new = y + rho * (y_new - y)
            if ms:
                zp_new = torch.clamp_min(zp + rho * (zp_new - zp), 0.0)
                zm_new = torch.clamp_min(zm + rho * (zm_new - zm), 0.0)
            if mg:
                zg_new = torch.clamp_min(zg + rho * (zg_new - zg), 0.0)
            x_new = torch.minimum(torch.maximum(x_new, lb), ub)
        return x_new, y_new, zp_new, zm_new, zg_new

    carry = (x, y, z[..., :ms], z[..., ms:2 * ms], z[..., 2 * ms:])
    budget = op.iters if iters is None else iters
    if isinstance(budget, torch.Tensor) and budget.ndim > 0:
        budget = budget.to(c.device)
        if c.is_cuda and torch.cuda.is_current_stream_capturing():
            if max_iters is None:
                raise ValueError("a captured solve with per-env budgets "
                                 "needs max_iters")
            count = max_iters
        else:
            count = int(budget.max()) if budget.numel() else 0
        for i in range(count):
            active = (i < budget)[:, None]
            carry = tuple(torch.where(active, new, old)
                          for new, old in zip(body(*carry), carry))
    else:
        for _ in range(int(budget)):
            carry = body(*carry)
    x, y, zp, zm, zg = carry
    return LPSolution(x=x, y=y, z=torch.cat([zp, zm, zg], -1))
