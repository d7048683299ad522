"""Batched contiguous row-slice gather: the hand-written Hopper kernel of
``csrc/exog_gather.cu`` and its plain PyTorch version.

``episode_slice_gather(table, starts, length)`` returns
``stack([table[s : s + length] for s in starts])``: the per-episode
prefetch of exogenous rows (CogenEnv's padded ambient days) at batch scale.
It replaces both ``sustaingym_tpu/ops/pallas/exog_gather.py::
_pallas_slice_gather`` (narrow tables) and ``::_pallas_hbm_slice_gather``
(wide tables): on the card one kernel serves every width, so
``hbm_slice_gather`` is the same function under the JAX package's second
name. What bounds the kernel and how it is laid out is in the ``.cu`` file.

A CUDA table launches the kernel (its count is ``episode_slice_gather.
launches``); a CPU table runs the plain version, one advanced-indexing
call. Both are pure copies, so they agree bit for bit.
"""
from __future__ import annotations

import torch

from ...core.graph import count_launches
from .wrap import I, P, bind, check, on_card, raise_on

__all__ = ["episode_slice_gather", "episode_slice_gather_ref",
           "hbm_slice_gather"]

_SIGNATURES = {"episode_slice_gather_launch": [P, I, P, I, I, P, P]}


def episode_slice_gather_ref(table: torch.Tensor, starts: torch.Tensor,
                             length: int) -> torch.Tensor:
    """Plain version: ``table[starts[:, None] + arange(length)]``."""
    return table[starts[:, None] + torch.arange(length, device=table.device)]


def episode_slice_gather(table: torch.Tensor, starts: torch.Tensor,
                         length: int) -> torch.Tensor:
    """(R, C) float32 table, (B,) int64 row starts with
    ``0 <= starts <= R - length`` -> (B, length, C)."""
    if not on_card(table, "episode_slice_gather"):
        return episode_slice_gather_ref(table, starts, length)
    dev = table.device
    if table.ndim != 2 or length <= 0:
        raise ValueError(f"episode_slice_gather: bad table "
                         f"{tuple(table.shape)} or length {length}")
    rows, cols = table.shape
    B = starts.shape[0]
    check("table", table, torch.float32, (rows, cols), dev)
    check("starts", starts, torch.long, (B,), dev)
    out = torch.empty((B, length, cols), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lo, hi = torch.stack(torch.aminmax(starts)).tolist()
    if lo < 0 or hi > rows - length:
        raise ValueError(f"episode_slice_gather: starts in [{lo}, {hi}] "
                         f"leave the ({rows}, {cols}) table for length "
                         f"{length}")
    with torch.cuda.device(dev):
        err = bind("exog_gather", _SIGNATURES).episode_slice_gather_launch(
            table.data_ptr(), cols, starts.data_ptr(), B, length,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "episode_slice_gather")
    episode_slice_gather.launches += 1
    return out


count_launches(episode_slice_gather)

# the JAX package's wide-table variant computes the same function
hbm_slice_gather = episode_slice_gather
