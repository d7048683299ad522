"""Plain dataclasses of tensors in place of JAX pytree dataclasses.

``Params``/``State`` types are ordinary ``@dataclass`` classes whose fields
are tensors (or Python constants); ``replace`` returns a modified copy, as
``flax.struct`` does in the JAX package. A "tree" is a tensor, a dict of
trees or a dataclass of trees; any other leaf (an int, a float, None) is
static and passes through the tree functions from the first tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import torch

__all__ = ["dataclass", "replace", "tree_assign_", "tree_map",
           "tree_select", "tree_stack"]

T = TypeVar("T")

dataclass = dataclasses.dataclass


def replace(obj: T, **changes: Any) -> T:
    """A copy of dataclass ``obj`` with ``changes`` applied."""
    return dataclasses.replace(obj, **changes)


def tree_map(fn: Callable[..., torch.Tensor], tree: T, *rest: T) -> T:
    """Applies ``fn`` to the matching tensor leaves of ``tree`` and
    ``rest``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def tree_select(pred: torch.Tensor, on_true: T, on_false: T) -> T:
    """Elementwise ``torch.where`` over matching trees; ``pred`` (B,) is
    broadcast over the trailing dims of every leaf."""
    def sel(a, b):
        return torch.where(pred.reshape(pred.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return tree_map(sel, on_true, on_false)


def tree_stack(trees: list[T], dim: int = 0) -> T:
    """Stacks a list of matching trees along a new axis ``dim``."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *trees)


def _leaves(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


@torch.no_grad()
def tree_assign_(dst: Any, src: Any) -> None:
    """Copies the tensor leaves of ``src`` into the matching leaves of
    ``dst`` in place. A leaf of ``src`` that shares memory with another
    leaf of ``dst`` (a field a step returned unchanged under another
    name) is cloned before any copy, so no copy reads a leaf that an
    earlier one overwrote."""
    d, s = _leaves(dst), _leaves(src)
    ptrs = {x.untyped_storage().data_ptr() for x in d}
    s = [x.clone() if x.untyped_storage().data_ptr() in ptrs
         and x.data_ptr() != y.data_ptr() else x for x, y in zip(s, d)]
    for x, y in zip(s, d):
        if x.data_ptr() != y.data_ptr():
            y.copy_(x)
