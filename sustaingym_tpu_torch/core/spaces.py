"""Space descriptors: ``Box``, ``Discrete``, ``MultiDiscrete``,
``DictSpace``, ``flatdim`` and ``flatten``.

Same semantics as ``sustaingym_tpu.core.spaces``: a ``DictSpace`` flattens
its entries in insertion order (``gymnasium.spaces.flatten`` order), a
``Discrete`` point one-hot and a ``MultiDiscrete`` point one one-hot per
dimension, so the flat observation layout, and with it the rows of a
converted ``trunk1`` weight, is the same in both packages.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from .graph import device_const

__all__ = ["Space", "Box", "Discrete", "MultiDiscrete", "DictSpace",
           "flatdim", "flatten"]


class Space:
    """Base class for all spaces."""


class Box(Space):
    """Continuous box in R^shape with elementwise bounds."""

    def __init__(self, low, high, shape: tuple[int, ...] | None = None):
        low = np.asarray(low, dtype=np.float64)
        high = np.asarray(high, dtype=np.float64)
        if shape is None:
            shape = np.broadcast_shapes(low.shape, high.shape)
        self.shape = tuple(shape)
        self.low = np.broadcast_to(low, self.shape).astype(np.float64)
        self.high = np.broadcast_to(high, self.shape).astype(np.float64)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """One uniform point, float32, on the generator's device."""
        return self.sample_batch(generator, 1)[0]

    def sample_batch(self, generator: torch.Generator, batch: int
                     ) -> torch.Tensor:
        """(batch, *shape) uniform points: ``low + u * (high - low)`` in
        float32, u ~ U[0, 1) from ``generator``."""
        dev = generator.device
        u = torch.rand((batch,) + self.shape, generator=generator, device=dev)
        low, high = device_const(self.low, dev), device_const(self.high, dev)
        return low + u * (high - low)

    def __repr__(self) -> str:
        return f"Box(shape={self.shape})"


class Discrete(Space):
    """The integers {start, ..., start + n - 1}."""

    def __init__(self, n: int, start: int = 0):
        self.n = int(n)
        self.start = int(start)
        self.shape = ()

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """One uniform point, int64, on the generator's device."""
        return self.sample_batch(generator, 1)[0]

    def sample_batch(self, generator: torch.Generator, batch: int
                     ) -> torch.Tensor:
        """(batch,) uniform integers from ``generator``."""
        return torch.randint(self.n, (batch,), generator=generator,
                             device=generator.device) + self.start

    def __repr__(self) -> str:
        return f"Discrete({self.n}, start={self.start})"


class MultiDiscrete(Space):
    """Independent integer dimensions, dimension i in {0, ..., nvec[i] - 1}."""

    def __init__(self, nvec):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = self.nvec.shape

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """One uniform point, int64, on the generator's device."""
        return self.sample_batch(generator, 1)[0]

    def sample_batch(self, generator: torch.Generator, batch: int
                     ) -> torch.Tensor:
        """(batch, *shape) points ``floor(u * nvec)``, u ~ U[0, 1) float32
        from ``generator``, as the JAX package samples."""
        dev = generator.device
        u = torch.rand((batch,) + self.shape, generator=generator, device=dev)
        nvec = device_const(self.nvec, dev)
        return torch.floor(u * nvec).long()

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class DictSpace(Space):
    """Ordered mapping of named sub-spaces."""

    def __init__(self, spaces: Mapping[str, Space]):
        self.spaces = dict(spaces)
        self.shape = None

    def __getitem__(self, name: str) -> Space:
        return self.spaces[name]

    def items(self):
        return self.spaces.items()

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v!r}" for k, v in self.spaces.items())
        return f"DictSpace({inner})"


def flatdim(space: Space) -> int:
    """Total number of scalar entries in a flattened point of ``space``."""
    if isinstance(space, Box):
        return int(np.prod(space.shape, dtype=np.int64)) if space.shape else 1
    if isinstance(space, Discrete):
        return space.n                     # one-hot
    if isinstance(space, MultiDiscrete):
        return int(space.nvec.sum())       # one one-hot per dimension
    if isinstance(space, DictSpace):
        return sum(flatdim(sp) for sp in space.spaces.values())
    raise TypeError(f"unknown space {space}")


def flatten(space: Space, x: Any, batch_dims: int = 0) -> torch.Tensor:
    """Flattens a point of ``space`` to a float32 tensor of shape
    (*batch, flatdim). The leading ``batch_dims`` axes of every entry are
    kept; dict entries concatenate in insertion order."""
    if isinstance(space, Box):
        x = torch.as_tensor(x, dtype=torch.float32)
        return x.reshape(x.shape[:batch_dims] + (-1,))
    if isinstance(space, Discrete):
        x = torch.as_tensor(x).long()
        return torch.nn.functional.one_hot(
            x.reshape(x.shape[:batch_dims]) - space.start,
            space.n).to(torch.float32)
    if isinstance(space, MultiDiscrete):
        x = torch.as_tensor(x).long()
        x = x.reshape(x.shape[:batch_dims] + (-1,))
        return torch.cat([torch.nn.functional.one_hot(x[..., i], int(k))
                          for i, k in enumerate(space.nvec.ravel())],
                         dim=-1).to(torch.float32)
    if isinstance(space, DictSpace):
        return torch.cat([flatten(sp, x[name], batch_dims)
                          for name, sp in space.spaces.items()], dim=-1)
    raise TypeError(f"unknown space {space}")
