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

import contextlib
from typing import Any, Callable, Generic, TypeVar

import torch

from . import trace
from .spaces import Space
from .struct import dataclass, replace, tree_map, tree_select

P = TypeVar("P")  # params dataclass
S = TypeVar("S")  # state dataclass

__all__ = ["TimeStep", "FunctionalEnv", "autoreset_step",
           "capturable_autoreset_step", "phased_autoreset_step",
           "reset_schedule", "ScheduleGuard", "resolve_device",
           "kernel_seed", "env_shard", "draw_env_rows", "env_offset"]


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

    phased = phased_autoreset_step(env)

    def step(params: P, state: S, action: Any,
             generator: torch.Generator | None = None
             ) -> tuple[S, TimeStep]:
        return phased(params, state, action, generator, True)

    return step


def reset_schedule(ep_len: int | None, phase: int, T: int) -> list[bool]:
    """Which of the next ``T`` steps end every episode of a batch whose
    episodes all began ``phase`` steps ago: step k (from 0) where
    ``(phase + k + 1) % ep_len == 0``. Every env of the suite has a fixed
    episode length, so a batch that starts together stays in lockstep (the
    reasoning behind the reference's ``lax.cond(any(done))`` in
    ``sustaingym_tpu/core/env.py``). With ``ep_len`` None every step may
    end an episode."""
    if not ep_len:
        return [True] * T
    return [(phase + k + 1) % ep_len == 0 for k in range(T)]


def phased_autoreset_step(env: FunctionalEnv[P, S]
                          ) -> Callable[..., tuple[S, TimeStep]]:
    """``step(params, state, action, generator, reset, guard=None)``: the
    batched ``env.step``, and where ``reset`` (a host bool: the steps
    :func:`reset_schedule` names) :func:`capturable_autoreset_step`'s
    whole-batch reset and ``torch.where`` selection. A step without
    ``reset`` draws and builds no reset. ``guard`` (a 0-d int64 tensor on
    the device) counts the steps that broke the schedule: a done at a
    step without ``reset``, or an env that did not end at a step with it.
    Nothing here reads it, so a CUDA graph captures the step."""

    def step(params: P, state: S, action: Any,
             generator: torch.Generator | None, reset: bool,
             guard: torch.Tensor | None = None) -> tuple[S, TimeStep]:
        next_state, ts = env.step(params, state, action, generator)
        done = ts.done
        if guard is not None:
            guard.add_((done.all() if reset else ~done.any()).logical_not())
        if not reset:
            return next_state, ts
        reset_state, reset_ts = env.reset(params, generator, done.shape[0])
        return (tree_select(done, reset_state, next_state),
                replace(ts, obs=tree_select(done, reset_ts.obs, ts.obs)))

    return step


class ScheduleGuard:
    """Reads :func:`phased_autoreset_step`'s guard one train step late, so
    the host never waits on the step it just queued: :meth:`push` after a
    step's work is queued starts a copy of the guard to the host and
    checks the previous step's copy; :meth:`check` reads the newest one
    (the end of a run). A count other than 0 raises and names the env."""

    def __init__(self, env, ep_len: int | None):
        self.env, self.ep_len = env, ep_len
        self.pending = None

    def push(self, guard: torch.Tensor) -> None:
        prev = self.pending
        if guard.device.type == "cuda":
            host = torch.empty((), dtype=guard.dtype, pin_memory=True)
            host.copy_(guard, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self.pending = (host, event)
        else:
            self.pending = (guard.clone(), None)
        if prev is not None:
            self._read(prev)

    def check(self) -> None:
        if self.pending is not None:
            self._read(self.pending)

    def _read(self, pending) -> None:
        host, event = pending
        if event is not None:
            trace.count("host_syncs.schedule_guard")
            event.synchronize()
        if int(host):
            name = getattr(self.env, "name", type(self.env).__name__)
            raise RuntimeError(
                f"{name}: {int(host)} autoreset step(s) broke the schedule "
                f"of episode_steps={self.ep_len} (an env ended off its "
                f"fixed episode length, or did not end on it)")


# (offset, local, total) env rows of this process under a data-parallel
# mesh, innermost last: entered by the learners around their phases
_SHARD: list[tuple[int, int, int]] = []


@contextlib.contextmanager
def env_shard(offset: int, local: int, total: int):
    """Within the block, every env-batch draw of ``local`` envs is made at
    the ``total`` (global) size and this process keeps its ``local`` rows
    from ``offset`` (:func:`draw_env_rows`), so a generator in the state
    of a one-process run draws the same global batch, and ends in the same
    state, for any number of processes. The cost: each process draws
    ``total / local`` times the numbers."""
    _SHARD.append((int(offset), int(local), int(total)))
    try:
        yield
    finally:
        _SHARD.pop()


def draw_env_rows(draw: Callable[[int], torch.Tensor], batch: int,
                  axis: int = 0) -> torch.Tensor:
    """``draw(n)`` (a tensor with n env rows on ``axis``) for ``batch``
    envs; under :func:`env_shard` the global batch's draw and this
    process's rows of it."""
    if not _SHARD:
        return draw(batch)
    offset, local, total = _SHARD[-1]
    if batch != local:
        raise ValueError(f"a draw for {batch} envs under a shard of "
                         f"{local} of {total}")
    return draw(total).narrow(axis, offset, local).contiguous()


def env_offset() -> int:
    """The global index of this process's first env (0 without a
    shard): the kernels' Philox streams key their draws by it."""
    return _SHARD[-1][0] if _SHARD else 0


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
    trace.count("host_syncs.kernel_seed")
    return int(torch.randint(2 ** 62, (1,), generator=generator,
                             device=generator.device))
