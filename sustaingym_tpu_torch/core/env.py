"""Environment protocol: ``TimeStep``, ``FunctionalEnv`` and the batched
autoreset.

As in ``sustaingym_tpu.core.env``, an env is a pair of functions of
explicit params and state,

    reset(params, generator, batch)            -> (state, timestep)
    step(params, state, action, generator)     -> (state, timestep)

but the batch axis is written out: every state and timestep tensor carries
a leading (B,) env axis instead of being vmapped, and random draws come
from a ``torch.Generator`` instead of a PRNG key.
"""
from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

import torch

from .spaces import Space
from .struct import dataclass, replace, tree_map, tree_select

P = TypeVar("P")  # params dataclass
S = TypeVar("S")  # state dataclass

__all__ = ["TimeStep", "FunctionalEnv", "autoreset_step",
           "capturable_autoreset_step", "resolve_device", "kernel_seed"]


@dataclass
class TimeStep:
    """One batched transition. ``info`` is a flat dict of (B,) tensors."""

    obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict[str, Any]

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


class FunctionalEnv(Generic[P, S]):
    """Base class: holds metadata; all numeric state flows through
    arguments."""

    #: name used by the registry
    name: str = "abstract"

    def reset(self, params: P, generator: torch.Generator, batch: int
              ) -> tuple[S, TimeStep]:
        raise NotImplementedError

    def step(self, params: P, state: S, action: Any,
             generator: torch.Generator | None = None) -> tuple[S, TimeStep]:
        raise NotImplementedError

    def observation_space(self, params: P) -> Space:
        raise NotImplementedError

    def action_space(self, params: P) -> Space:
        raise NotImplementedError

    def episode_steps(self, params: P) -> int | None:
        """Static episode length, or None if variable."""
        return None


def autoreset_step(env: FunctionalEnv[P, S]
                   ) -> Callable[..., tuple[S, TimeStep]]:
    """Wraps the batched ``env.step`` with auto-reset: the envs whose
    episode ended get the state and obs of a freshly reset episode, while
    the reward, terminated, truncated and info of the finishing step are
    kept. Only the done envs are reset (one ``env.reset`` of that many
    envs, drawn from ``generator``); the others keep their stepped state.
    The per-env semantics are those of ``sustaingym_tpu.core.env.
    autoreset_step``."""

    def step(params: P, state: S, action: Any,
             generator: torch.Generator | None = None
             ) -> tuple[S, TimeStep]:
        next_state, ts = env.step(params, state, action, generator)
        idx = ts.done.nonzero()[:, 0]
        if idx.numel() == 0:
            return next_state, ts
        reset_state, reset_ts = env.reset(params, generator, idx.numel())

        def put(a, r):
            return a.index_copy(0, idx, r)

        return (tree_map(put, next_state, reset_state),
                replace(ts, obs=tree_map(put, ts.obs, reset_ts.obs)))

    return step


def capturable_autoreset_step(env: FunctionalEnv[P, S]
                              ) -> Callable[..., tuple[S, TimeStep]]:
    """:func:`autoreset_step` without a host synchronisation, so that a
    CUDA graph can capture it: every step resets the whole batch (one
    ``env.reset`` of B envs drawn from ``generator``) and each env takes
    the reset state and obs where its episode ended (``torch.where``).
    The per-env semantics are ``autoreset_step``'s; the draws are not: it
    draws a whole batch's resets at every step, where ``autoreset_step``
    draws one reset per ended episode at the steps where episodes end."""

    def step(params: P, state: S, action: Any,
             generator: torch.Generator | None = None
             ) -> tuple[S, TimeStep]:
        next_state, ts = env.step(params, state, action, generator)
        done = ts.done
        reset_state, reset_ts = env.reset(params, generator, done.shape[0])
        return (tree_select(done, reset_state, next_state),
                replace(ts, obs=tree_select(done, reset_ts.obs, ts.obs)))

    return step


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device without a CUDA card
    is an error, never a silent move to the CPU: pass ``device="cpu"`` to
    run there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available. The port runs on "
            f"the card by default; pass device='cpu' to run on the CPU.")
    return device


def kernel_seed(generator: torch.Generator | None) -> int:
    """A 62-bit seed for a kernel's Philox stream, drawn from
    ``generator``."""
    if generator is None:
        raise ValueError("in-kernel draws need a torch.Generator")
    return int(torch.randint(2 ** 62, (1,), generator=generator,
                             device=generator.device))
