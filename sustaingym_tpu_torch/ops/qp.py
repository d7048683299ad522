"""Batched fixed-iteration dual-FISTA projection for the EV action
feasibility set (the ``DualSOCProjection`` path of ``sustaingym_tpu.ops.qp``).

Problem:
    minimize    1/2 ||x - a||^2
    subject to  0 <= x <= ub                     (box, ub per instance)
                ||C_k x|| <= r_k, k = 1..m      (phase-aggregate SOC limits)

where each C_k stacks the real/imag parts of one row of the complex
constraint matrix A~ = constraint_matrix * exp(j * phase_angle).

Only the float32 chain is ported. The JAX package's ``inner_bf16`` option
keeps the x-space chain in bfloat16 to save TPU memory traffic; the CUDA
episode kernels keep it in registers and run f32, so the port does too.
The legacy ADMM operator is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.env import resolve_device
from ..core.struct import dataclass

__all__ = ["DualSOCProjection", "make_dual_soc_projection", "project"]


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


def project(op: DualSOCProjection, a: torch.Tensor, ub: torch.Tensor
            ) -> torch.Tensor:
    """Projects ``a`` (..., n) onto {0 <= x <= ub} ∩ {||C_k x|| <= r_k}.

    FISTA on the dual  min_lam  f*(-C' lam) + sum_k r_k ||lam_k||  with
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
