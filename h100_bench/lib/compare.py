"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs.
Each is a share (0 where the two agree); its limit lives in
``limits/<workload>.json``."""
from __future__ import annotations

import math
import statistics

import torch


def leaf_norm_gaps(prog: dict, ref: dict, grad_ref: dict | None = None
                   ) -> list[float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of the reference
    leaf's norm and the median leaf's. ``grad_ref`` (the reference's
    gradient, Adam's first moment) leaves out leaves whose gradient is
    nought to rounding: under a thousandth of the median leaf's norm."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
             ref.items()}
    keep = set(ref)
    if grad_ref is not None:
        g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
             grad_ref.items()}
        med = statistics.median(g.values())
        keep = {k for k in ref if g[k] >= 1e-3 * med}
    med = statistics.median(norms[k] for k in keep)
    return [abs(float(torch.linalg.vector_norm(
        prog[k].double().to(ref[k].device))) - norms[k])
        / max(norms[k], med, 1e-30) for k in sorted(keep)]


def leaf_norm_gap(prog: dict, ref: dict, grad_ref: dict | None = None
                  ) -> float:
    """The worst leaf of :func:`leaf_norm_gaps`."""
    return worst(leaf_norm_gaps(prog, ref, grad_ref))


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's |‖prog‖ - ‖ref‖| / ‖ref‖ (a diagnostic)."""
    out = {}
    for k, r in ref.items():
        rn = float(torch.linalg.vector_norm(r.double()))
        pn = float(torch.linalg.vector_norm(prog[k].double().to(r.device)))
        out[k] = abs(pn - rn) / max(rn, 1e-30)
    return out


def worst(values) -> float:
    """The largest of ``values``; inf where any is not finite (a NaN
    would otherwise be lost to ``max``)."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)


def mean_abs_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """sum |prog - ref| / sum |ref|."""
    ref = ref.double()
    prog = prog.to(ref.device).double()
    return worst([float((prog - ref).abs().sum()
                        / ref.abs().sum().clamp_min(1e-30))])


def return_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of an env's episode total (the sum over steps of (T, B)
    or (T, B, C) outputs), over the column's mean absolute total; a column
    whose totals are smaller than column 0's (the reward) is measured on
    the reward's scale, so a column that is mostly 0 does not blow up."""
    ref = ref.double().sum(0)
    prog = prog.to(ref.device).double().sum(0)
    if ref.ndim == 1:
        ref, prog = ref[:, None], prog[:, None]
    scale = ref.abs().mean(0)
    scale = torch.maximum(scale, scale[0]).clamp_min(1e-30)
    return worst([float(((prog - ref).abs().max(0).values / scale).max())])


def loss_gap(prog: list, ref: list, term: int) -> float:
    """Worst step of |prog - ref| / |ref| of the loss term ``term`` of
    each step's (pg, vf, entropy) means."""
    return worst(abs(p[term] - r[term]) / max(abs(r[term]), 1e-30)
                 for p, r in zip(prog, ref))


def judge(numbers: dict, limits: dict) -> bool:
    """True where every number is finite and within its limit."""
    return all(v == v and v <= limits[k] for k, v in numbers.items())
