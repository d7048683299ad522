"""The (dp, mp) rank mesh: ``sustaingym_tpu.parallel.mesh`` on
``torch.distributed``.

The JAX package lays its devices out as a (dp, mp) ``Mesh``: the env
batch and trajectories sharded over ``dp``, the policy MLP's hidden
dimension over ``mp``, and XLA inserts the collectives. The port runs one
process a rank, rank ``d * mp + m`` at mesh coordinates (d, m), and names
its collectives: the learners all-reduce gradients and metrics over the
dp group (the ranks of one m) and the trunk2 partial sums over the mp
group (the ranks of one d). A mesh of one rank has no group, and every
learner path on it is the one-card path, unchanged.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from .distributed import process_rows, world

__all__ = ["Mesh", "make_mesh", "mp_all_reduce"]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (dp, mp) mesh: coordinates (d, m), its
    device, and the process groups of its dp row and mp column (None
    where that axis has one rank)."""
    dp: int
    mp: int
    d: int
    m: int
    device: torch.device
    dp_group: Any = None
    mp_group: Any = None

    @property
    def rank(self) -> int:
        return self.d * self.mp + self.m

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def data_slice(self, total: int) -> slice:
        """This rank's rows of a global batch axis of ``total``."""
        return process_rows(total, self.d, self.dp)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor: every rank holds all of it."""
        return x

    def model_shard(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's slice of ``x`` along ``axis``, split over mp."""
        size = x.shape[axis]
        if size % self.mp:
            raise ValueError(f"axis {axis} of {size} not divisible by "
                             f"mp={self.mp}")
        k = size // self.mp
        return x.narrow(axis, self.m * k, k).clone()

    def unshard(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The whole tensor of which ``x`` is this rank's
        :meth:`model_shard` (an all-reduce of zero-padded shards over mp:
        gloo and NCCL both have it for CUDA tensors)."""
        if self.mp == 1:
            return x.clone()
        shape = list(x.shape)
        k = shape[axis]
        shape[axis] = k * self.mp
        full = x.new_zeros(shape)
        full.narrow(axis, self.m * k, k).copy_(x)
        dist.all_reduce(full, group=self.mp_group)
        return full

    def dp_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the dp group, in place."""
        if self.dp > 1:
            dist.all_reduce(x, group=self.dp_group)
        return x

    def mp_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the mp group, in place."""
        if self.mp > 1:
            dist.all_reduce(x, group=self.mp_group)
        return x


def make_mesh(n: int | None = None, mp: int = 1, device="cuda") -> Mesh:
    """The (n / mp, mp) mesh of the ``n`` ranks of the process group (all
    of them; ``n`` None is the world size, 1 without a group). Every rank
    calls it, in the same order as any other group it makes. ``device``
    "cuda" is the card of the rank's ``LOCAL_RANK`` (modulo the cards, so
    ranks may share one); "cpu" the CPU."""
    rank, size = world()
    n = size if n is None else int(n)
    if n != size:
        raise ValueError(f"a mesh of {n} ranks needs {n} processes; the "
                         f"process group has {size} (init_distributed)")
    if mp < 1 or n % mp:
        raise ValueError(f"mesh of {n} ranks not divisible by mp={mp}")
    dp = n // mp
    d, m = divmod(rank, mp)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % max(torch.cuda.device_count(),
                                                  1))
    dp_group = mp_group = None
    if size > 1:
        if mp > 1:
            for i in range(dp):
                g = dist.new_group([i * mp + j for j in range(mp)])
                if i == d:
                    mp_group = g
        if dp > 1:
            for j in range(mp):
                g = dist.new_group([i * mp + j for i in range(dp)])
                if j == m:
                    dp_group = g
    return Mesh(dp=dp, mp=mp, d=d, m=m, device=device, dp_group=dp_group,
                mp_group=mp_group)


class _MpSum(torch.autograd.Function):
    """Forward: the partial sums all-reduced (SUM) over the mp group;
    backward: the identity (the cotangent is the same on every mp rank)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def mp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's partial products summed over the mp group
    (Megatron's "g" operator); ``group`` None is the identity."""
    return x if group is None else _MpSum.apply(x, group)
