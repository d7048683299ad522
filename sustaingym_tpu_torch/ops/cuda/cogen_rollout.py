"""Whole CogenEnv dispatch days: the hand-written Hopper kernel of
``csrc/cogen_rollout.cu``, and its plain PyTorch version.

``cogen_segment`` replaces ``sustaingym_tpu/ops/pallas/cogen_rollout.py::
fused_cogen_segment``, the simulation tier's episode kernel. What bounds
it and how it is laid out is in the ``.cu`` file.

Both return the segment as (30, T, B) float32 rows, env-minor:
[0:15] the actions, [15] the reward, [16:19] fuel costs, [19:23] ramp
costs, [23:27] constraint-violation costs, [27] the non-delivery cost,
[28] net power, [29] process steam; ``segment_fields`` views them as the
env's (T, B, ...) fields.

A CUDA ``params.ambients`` launches the kernel (its count is
``cogen_segment.launches``); a CPU one runs ``cogen_segment_ref``, which
steps ``envs.cogen.env.step_core`` one step at a time: the oracle for the
kernel. Random draws: the kernel uses a Philox stream keyed by ``seed``,
the plain version a ``torch.Generator`` seeded with ``seed``; both draw
``envs.cogen.env.sample_action``'s distribution, but not the same numbers.
"""
from __future__ import annotations

import torch

from ...core.graph import count_launches
from ...envs.cogen.env import CogenParams, sample_action, step_core
from .wrap import F, I, P, U64, bind, check, on_card, ptr, raise_on, seeded

__all__ = ["cogen_segment", "cogen_segment_ref", "segment_fields",
           "OUT_ROWS", "OPS_PER_STEP"]

OUT_ROWS = 30
N_ACT = 15
# float operations of one env step of the kernel (plant surrogate, the
# 16 violations and the reward), counted from the .cu source
OPS_PER_STEP = 320

_SIGNATURES = {"cogen_segment_launch": [P, I, I, P, P, P, F, F, F, I, I, U64,
                                        P, P]}


def segment_fields(out: torch.Tensor):
    """(actions (T, B, 15), reward (T, B), info) views of a (30, T, B)
    segment."""
    def rows(lo, hi):
        return out[lo:hi].permute(1, 2, 0)

    info = {"fuel_costs": rows(16, 19), "ramp_costs": rows(19, 23),
            "dyn_cv_costs": rows(23, 27), "non_delivery_cost": out[27],
            "net_power": out[28], "proc_steam": out[29]}
    return rows(0, N_ACT), out[15], info


def cogen_segment_ref(params: CogenParams, days: torch.Tensor,
                      prev0: torch.Tensor, T: int,
                      actions: torch.Tensor | None = None,
                      seed: int = 0) -> torch.Tensor:
    """Plain version of :func:`cogen_segment`."""
    B, dev = days.shape[0], params.device
    gen = seeded(dev, seed) if actions is None else None
    out = torch.empty((OUT_ROWS, T, B), dtype=torch.float32, device=dev)
    prev = prev0
    for t in range(T):
        a = actions[t] if actions is not None else sample_action(gen, B)
        reward, info = step_core(params, prev, a, params.ambients[days, t])
        out[:N_ACT, t] = a.T
        out[15, t] = reward
        out[16:19, t] = info["fuel_costs"].T
        out[19:23, t] = info["ramp_costs"].T
        out[23:27, t] = info["dyn_cv_costs"].T
        out[27, t] = info["non_delivery_cost"]
        out[28, t] = info["net_power"]
        out[29, t] = info["proc_steam"]
        prev = a
    return out


def cogen_segment(params: CogenParams, days: torch.Tensor,
                  prev0: torch.Tensor, T: int,
                  actions: torch.Tensor | None = None,
                  seed: int = 0) -> torch.Tensor:
    """One day segment of B = len(days) envs from reset, T <= 96 steps:
    ``days`` (B,) int64, ``prev0`` (B, 15) the reset actions (the first
    ramp term's reference). ``actions`` (T, B, 15) prescribed, else drawn
    in the kernel from a Philox stream keyed by ``seed``. Returns (30, T, B)
    float32 rows (module docstring)."""
    amb = params.ambients
    if not on_card(amb, "cogen_segment"):
        return cogen_segment_ref(params, days, prev0, T, actions, seed)
    dev = amb.device
    B = days.shape[0]
    if amb.ndim != 3 or amb.shape[2] < 5 \
            or not 0 < T <= params.timesteps_per_day:
        raise ValueError(f"cogen_segment: bad ambient table "
                         f"{tuple(amb.shape)} for T={T}")
    check("ambients", amb, torch.float32, amb.shape, dev)
    check("days", days, torch.long, (B,), dev)
    check("prev0", prev0, torch.float32, (B, N_ACT), dev)
    if actions is not None:
        check("actions", actions, torch.float32, (T, B, N_ACT), dev)
    out = torch.empty((OUT_ROWS, T, B), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lo, hi = torch.stack(torch.aminmax(days)).tolist()
    if lo < 0 or hi >= amb.shape[0]:
        raise ValueError(f"cogen_segment: days in [{lo}, {hi}] outside "
                         f"0 .. {amb.shape[0] - 1}")
    with torch.cuda.device(dev):
        err = bind("cogen_rollout", _SIGNATURES).cogen_segment_launch(
            amb.data_ptr(), amb.shape[1], amb.shape[2], days.data_ptr(),
            prev0.data_ptr(), ptr(actions), params.ramp_penalty,
            params.supply_imbalance_penalty,
            params.constraint_violation_penalty, B, T, seed % 2 ** 64,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "cogen_segment")
    cogen_segment.launches += 1
    return out


count_launches(cogen_segment)
