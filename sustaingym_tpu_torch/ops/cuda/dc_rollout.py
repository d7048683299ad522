"""Whole DataCenterEnv episodes: the hand-written Hopper kernel of
``csrc/dc_rollout.cu``, and its plain PyTorch version.

``dc_segment`` replaces ``sustaingym_tpu/ops/pallas/dc_rollout.py::
fused_dc_segment``, the simulation tier's episode kernel. What bounds it
and how it is laid out is in the ``.cu`` file.

Both return the segment as (6, T, B) float32 rows, env-minor: the VCC a,
the executed load, the queue, the reward, the carbon cost and the delay
penalty. Each env starts from a zero queue and zero day sums (an episode
start).

A CUDA ``params.table`` launches the kernel (its count is
``dc_segment.launches``); a CPU one runs ``dc_segment_ref``, which steps
``envs.datacenter.env.step_core`` one hour at a time: the oracle for the
kernel, equal to it bit for bit. Random draws: the kernel uses a Philox
stream keyed by ``seed``, the plain version a ``torch.Generator`` seeded
with ``seed``; both draw U[0, 1), but not the same numbers.
"""
from __future__ import annotations

import torch

from ...core.graph import count_launches
from ...envs.datacenter.env import DCParams, step_core
from .wrap import I, P, U64, bind, check, on_card, ptr, raise_on, seeded

__all__ = ["dc_segment", "dc_segment_ref", "OUT_ROWS", "OPS_PER_STEP"]

OUT_ROWS = 6
# float operations of one env step of the kernel, counted from the .cu
# source (clip, queue, carbon, day sums, penalty, reward)
OPS_PER_STEP = 15

_SIGNATURES = {"dc_segment_launch": [P, I, P, P, I, I, U64, P, P]}


def dc_segment_ref(params: DCParams, months: torch.Tensor, T: int,
                   actions: torch.Tensor | None = None,
                   seed: int = 0) -> torch.Tensor:
    """Plain version of :func:`dc_segment`."""
    B, dev = months.shape[0], params.device
    gen = seeded(dev, seed) if actions is None else None
    out = torch.empty((OUT_ROWS, T, B), dtype=torch.float32, device=dev)
    queue = day_vcc = day_arr = torch.zeros(B, dtype=torch.float32,
                                            device=dev)
    for t in range(T):
        if actions is None:
            a = torch.rand(B, generator=gen, device=dev)
        else:
            a = actions[t].clamp(0.0, 1.0)
        x = params.table[months, t]                           # (B, 2)
        queue, day_vcc, day_arr, executed, carbon, delay, reward = step_core(
            queue, day_vcc, day_arr, a, x[:, 0], x[:, 1], t)
        out[:, t] = torch.stack([a, executed, queue, reward, carbon, delay])
    return out


def dc_segment(params: DCParams, months: torch.Tensor, T: int,
               actions: torch.Tensor | None = None,
               seed: int = 0) -> torch.Tensor:
    """One episode segment of B = len(months) envs from an episode start,
    T <= 696 hours: ``months`` (B,) int64; ``actions`` (T, B) prescribed
    VCCs (clipped to [0, 1]), else drawn U[0, 1) in the kernel from a
    Philox stream keyed by ``seed``. Returns (6, T, B) float32 rows
    (module docstring)."""
    table = params.table
    if not on_card(table, "dc_segment"):
        return dc_segment_ref(params, months, T, actions, seed)
    dev = table.device
    B = months.shape[0]
    if table.ndim != 3 or table.shape[2] != 2 or not 0 < T <= table.shape[1]:
        raise ValueError(f"dc_segment: bad table {tuple(table.shape)} for "
                         f"T={T}")
    check("table", table, torch.float32, table.shape, dev)
    check("months", months, torch.long, (B,), dev)
    if actions is not None:
        check("actions", actions, torch.float32, (T, B), dev)
    out = torch.empty((OUT_ROWS, T, B), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lo, hi = torch.stack(torch.aminmax(months)).tolist()
    if lo < 0 or hi >= table.shape[0]:
        raise ValueError(f"dc_segment: months in [{lo}, {hi}] outside "
                         f"0 .. {table.shape[0] - 1}")
    with torch.cuda.device(dev):
        err = bind("dc_rollout", _SIGNATURES).dc_segment_launch(
            table.data_ptr(), table.shape[1], months.data_ptr(), ptr(actions),
            B, T, seed % 2 ** 64, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "dc_segment")
    dc_segment.launches += 1
    return out


count_launches(dc_segment)
