"""Plain dataclasses of tensors in place of JAX pytree dataclasses.

``Params``/``State`` types are ordinary ``@dataclass`` classes whose fields
are tensors (or Python constants); ``replace`` returns a modified copy, as
``flax.struct`` does in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

__all__ = ["dataclass", "replace"]

T = TypeVar("T")

dataclass = dataclasses.dataclass


def replace(obj: T, **changes: Any) -> T:
    """A copy of dataclass ``obj`` with ``changes`` applied."""
    return dataclasses.replace(obj, **changes)

