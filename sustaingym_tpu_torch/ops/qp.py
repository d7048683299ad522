"""Batched fixed-iteration projections for the EV action feasibility set:
the two operators of ``sustaingym_tpu.ops.qp``.

Problem:
    minimize    1/2 ||x - a||^2
    subject to  0 <= x <= ub                     (box, ub per instance)
                ||C_k x|| <= r_k, k = 1..m      (phase-aggregate SOC limits)

where each C_k stacks the real/imag parts of one row of the complex
constraint matrix A~ = constraint_matrix * exp(j * phase_angle).

``DualSOCProjection`` (the default, :func:`make_dual_soc_projection`):
preconditioned FISTA on the 2m-dimensional dual. Only its float32 chain is
ported: the JAX package's ``inner_bf16`` option keeps the x-space chain in
bfloat16 to save TPU memory traffic; the CUDA episode kernels keep it in
registers and run f32, so the port does too.

``SOCProjection`` (:func:`make_soc_projection`, ``proj_method="admm"``):
over-relaxed ADMM with the (n, n) system inverted once on the host. Its
products run in float32, as the JAX package pins them.

:func:`project` dispatches on the operator's type.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.env import resolve_device
from ..core.struct import dataclass

__all__ = ["SOCProjection", "DualSOCProjection", "make_soc_projection",
           "make_dual_soc_projection", "project"]


@dataclass
class SOCProjection:
    """Over-relaxed ADMM operator. ``rho`` and ``alpha`` are float32
    values held as Python floats, so that the products by them (and by
    ``1 - alpha``, rounded in float32) need no device constant."""
    C: torch.Tensor       # (2m, n) stacked [Re; Im] rows, interleaved per cone
    K: torch.Tensor       # (n, n) inverse of ((1+rho) I + rho C^T C)
    radii: torch.Tensor   # (m,) cone radii (normalized units)
    rho: float
    alpha: float          # over-relaxation factor (1.0 = plain ADMM)
    n: int
    m: int
    iters: int = 50


@dataclass
class DualSOCProjection:
    """Preconditioned dual-FISTA projection operator."""
    C: torch.Tensor       # (2m, n) stacked [Re; Im] rows, interleaved per cone
    radii: torch.Tensor   # (m,) cone radii (normalized units)
    step: torch.Tensor    # (m,) per-cone dual step sizes (scale included)
    n: int
    m: int
    iters: int = 20
    restart: bool = True


def _interleaved_C(constraint_matrix: np.ndarray,
                   phase_angles_deg: np.ndarray) -> np.ndarray:
    phase = np.exp(1j * np.deg2rad(np.asarray(phase_angles_deg)))
    a_tilde = np.asarray(constraint_matrix) * phase[None, :]
    m, n = a_tilde.shape
    C = np.empty((2 * m, n), dtype=np.float64)
    C[0::2] = a_tilde.real
    C[1::2] = a_tilde.imag
    return C


def make_soc_projection(constraint_matrix: np.ndarray,
                        phase_angles_deg: np.ndarray,
                        magnitudes: np.ndarray,
                        action_scale: float = 32.0,
                        rho: float = 2.0,
                        iters: int = 50,
                        alpha: float = 1.7,
                        device="cuda") -> SOCProjection:
    """Builds the ADMM operator (host NumPy, K inverted in float64, stored
    float32 on ``device``; the card unless the caller asks for the CPU).
    ``alpha`` is the over-relaxation (Boyd et al. §3.4.3)."""
    C = _interleaved_C(constraint_matrix, phase_angles_deg)
    m2, n = C.shape
    radii = np.asarray(magnitudes, dtype=np.float64) / action_scale
    K = np.linalg.inv((1.0 + rho) * np.eye(n) + rho * (C.T @ C))
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return SOCProjection(
        C=torch.as_tensor(C, **f32), K=torch.as_tensor(K, **f32),
        radii=torch.as_tensor(radii, **f32), rho=float(np.float32(rho)),
        alpha=float(np.float32(alpha)), n=int(n), m=m2 // 2,
        iters=int(iters))


def make_dual_soc_projection(constraint_matrix: np.ndarray,
                             phase_angles_deg: np.ndarray,
                             magnitudes: np.ndarray,
                             action_scale: float = 32.0,
                             iters: int = 20,
                             step_scale: float | None = 2.0,
                             restart: bool = True,
                             device="cuda") -> DualSOCProjection:
    """Builds the preconditioned dual-FISTA operator (host NumPy, float64,
    stored float32 on ``device``; the card unless the caller asks for the
    CPU).

    Per-cone base steps t_k = 1 / max-row block sum of |C C'|;
    ``step_scale`` multiplies them (2.0, the default, is validated
    convergent for both packaged sites with gradient restart), and
    ``None`` picks the provable spectral scaling 1 / ||sqrt(T) C||_2^2.
    """
    if not restart and step_scale is not None and step_scale > 1.0:
        # the 2x overstep is only validated stable with gradient restart
        import warnings
        warnings.warn(
            f"make_dual_soc_projection: step_scale={step_scale} without "
            f"restart is not validated stable; falling back to the provable "
            f"spectral step (step_scale=None). Pass step_scale explicitly "
            f"<= 1.0 to silence.", stacklevel=2)
        step_scale = None
    C = _interleaved_C(constraint_matrix, phase_angles_deg)
    m = C.shape[0] // 2
    radii = np.asarray(magnitudes, dtype=np.float64) / action_scale
    G = np.abs(C @ C.T)
    t = 1.0 / np.maximum(G.reshape(m, 2, 2 * m).sum(-1).max(-1), 1e-12)
    if step_scale is None:
        sqT = np.sqrt(np.repeat(t, 2))
        t = t / (np.linalg.norm(sqT[:, None] * C, 2) ** 2)
    else:
        t = t * float(step_scale)
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return DualSOCProjection(
        C=torch.as_tensor(C, **f32), radii=torch.as_tensor(radii, **f32),
        step=torch.as_tensor(t, **f32), n=int(C.shape[1]), m=int(m),
        iters=int(iters), restart=bool(restart))


def _ball_project(v: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """Projects interleaved (re, im) pairs of v (..., 2m) onto balls of
    the given radii."""
    pairs = v.reshape(*v.shape[:-1], -1, 2)
    norm = torch.sqrt(torch.sum(pairs * pairs, -1) + 1e-12)
    scale = torch.clamp(radii / norm, max=1.0)
    return (pairs * scale[..., None]).reshape(v.shape)


def _project_admm(op: SOCProjection, a: torch.Tensor, ub: torch.Tensor
                  ) -> torch.Tensor:
    """``op.iters`` over-relaxed ADMM iterations on the splitting x = z0
    (box), C x = zc (cones):
        x   = K (a + rho (z0 - u0) + rho C' (zc - uc))
        xh  = alpha x + (1 - alpha) z0,  cxh = alpha C x + (1 - alpha) zc
        z0  = clip(xh + u0, 0, ub),      zc = ball(cxh + uc)
        u0 += xh - z0,                   uc += cxh - zc
    then the box-feasible clip of x. Full-f32 products (no TF32)."""
    rho, alpha = op.rho, op.alpha
    beta = float(np.float32(1.0) - np.float32(alpha))   # f32 1 - alpha
    C, Kt = op.C, op.K.T
    ub = torch.as_tensor(ub, dtype=a.dtype, device=a.device)
    x = torch.minimum(torch.clamp(a, min=0.0), ub)
    z0, u0 = x, torch.zeros_like(x)
    zc = x @ C.T
    uc = torch.zeros_like(zc)
    for _ in range(op.iters):
        rhs = a + rho * (z0 - u0) + rho * ((zc - uc) @ C)
        x = rhs @ Kt
        cx = x @ C.T
        xh = alpha * x + beta * z0
        cxh = alpha * cx + beta * zc
        z0 = torch.minimum(torch.clamp(xh + u0, min=0.0), ub)
        zc = _ball_project(cxh + uc, op.radii)
        u0 = u0 + xh - z0
        uc = uc + cxh - zc
    return torch.minimum(torch.clamp(x, min=0.0), ub)


def project(op, a: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """Projects ``a`` (..., n) onto {0 <= x <= ub} ∩ {||C_k x|| <= r_k}
    with ``op``: ADMM for an :class:`SOCProjection`, dual FISTA for a
    :class:`DualSOCProjection`."""
    if isinstance(op, SOCProjection):
        return _project_admm(op, a, ub)
    return _project_dual(op, a, ub)


def _project_dual(op: DualSOCProjection, a: torch.Tensor, ub: torch.Tensor
                  ) -> torch.Tensor:
    """FISTA on the dual  min_lam  f*(-C' lam) + sum_k r_k ||lam_k||  with
    f(x) = 1/2 ||x - a||^2 + I_box(x):
        xbar    = clip(a - C' y, 0, ub)
        lam_new = blockshrink(y + T C xbar, T r)
        y       = lam_new + beta (lam_new - lam)   (gradient-restart Nesterov)
    The matmuls must run in full float32 (no TF32 on the card)."""
    batch = a.shape[:-1]
    C = op.C
    lam = torch.zeros(batch + (2 * op.m,), dtype=a.dtype, device=a.device)
    lam_prev = lam
    tk = torch.ones(batch, dtype=a.dtype, device=a.device)
    t2 = torch.repeat_interleave(op.step, 2)
    tr = op.step * op.radii
    ub = torch.as_tensor(ub, dtype=a.dtype, device=a.device)

    def shrink(w):
        pairs = w.reshape(*w.shape[:-1], op.m, 2)
        nr = torch.sqrt(torch.sum(pairs * pairs, -1) + 1e-12)
        sc = torch.clamp(1.0 - tr / nr, min=0.0)
        return (pairs * sc[..., None]).reshape(w.shape)

    for _ in range(op.iters):
        tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        beta = (tk - 1.0) / tk1
        y = lam + beta[..., None] * (lam - lam_prev)
        xbar = torch.minimum(torch.clamp(a - y @ C, min=0.0), ub)
        lam_new = shrink(y + t2 * (xbar @ C.T))
        if op.restart:
            # gradient restart (O'Donoghue & Candes): momentum reset when
            # the step moves against the previous direction
            prog = torch.sum((lam_new - lam) * (lam - lam_prev), -1)
            tk1 = torch.where(prog < 0.0, torch.ones_like(tk1), tk1)
        lam_prev, lam, tk = lam, lam_new, tk1
    return torch.minimum(torch.clamp(a - lam @ C, min=0.0), ub)
