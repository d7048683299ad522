"""Environment protocol: ``TimeStep`` and ``FunctionalEnv``.

As in ``sustaingym_tpu.core.env``, an env is a pair of functions of
explicit params and state,

    reset_at_day / reset(params, ...) -> (state, timestep)
    step(params, state, action)      -> (state, timestep)

but the batch axis is written out: every state and timestep tensor carries
a leading (B,) env axis instead of being vmapped.
"""
from __future__ import annotations

from typing import Any, Generic, TypeVar

import torch

from .spaces import Space
from .struct import dataclass

P = TypeVar("P")  # params dataclass
S = TypeVar("S")  # state dataclass

__all__ = ["TimeStep", "FunctionalEnv"]


@dataclass
class TimeStep:
    """One batched transition. ``info`` is a flat dict of (B,) tensors."""

    obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict[str, Any]


class FunctionalEnv(Generic[P, S]):
    """Base class: holds metadata; all numeric state flows through
    arguments."""

    #: name used by the registry
    name: str = "abstract"

    def step(self, params: P, state: S, action: Any) -> tuple[S, TimeStep]:
        raise NotImplementedError

    def observation_space(self, params: P) -> Space:
        raise NotImplementedError

    def action_space(self, params: P) -> Space:
        raise NotImplementedError

    def episode_steps(self, params: P) -> int | None:
        """Static episode length, or None if variable."""
        return None
