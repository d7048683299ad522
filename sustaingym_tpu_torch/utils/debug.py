"""Finite and bounds checks of env transitions that never read the host:
the port of ``sustaingym_tpu.utils.debug`` (``jax.experimental.checkify``).

Inside a batched step a NaN silently poisons the whole batch. Wrap a
functional env in the checked helpers during development and every reset
and step also checks, in the JAX module's order, that

* every float obs leaf is finite (``"non-finite value in obs leaf {i}"``,
  leaves numbered as ``jax.tree.flatten`` numbers them: dict keys sorted),
* the reward is finite (``"non-finite reward"``),
* every float ``info`` entry is finite, by sorted key
  (``"non-finite info[{name}]"``),
* terminated and truncated are 0 or 1 (``"terminated/truncated not
  boolean"``),
* (with ``check_bounds``) the obs lies inside the env's declared
  observation space: Box leaves within their bounds plus a slack of
  ``1e-5 * (1 + |low| + |high|)``, MultiDiscrete and Discrete leaves in
  range, Dict entries walked by key; a space the walk cannot read raises
  TypeError at once (a requested bounds check is never a no-op).

The result of the checks is an :class:`Error`: a 0-d int32 tensor on the
device holding the number of the first failed check (0 = clean), kept
with ``torch.where``, beside a host-side table of messages. No check reads
the host (no ``.item()``, no ``.cpu()``), so a checked step loop can run
inside a CUDA graph (``core/graph.py::Graphs`` with
``core.env.capturable_autoreset_step``); :meth:`Error.throw` is the one
host read, as ``checkify.Error.throw()`` is.

Divergence by design: checkify's ``float_checks`` also flag a NaN or a
division by zero inside an intermediate op of the step; these checks see
what the step returns.

Typical use::

    env, params = make("cogen")
    (state, ts), err = checked_reset(env)(params, generator, 1024)
    err.throw()                       # raises if the reset produced NaNs

or, the one-call batch smoke test::

    validate_batch_rollout(env, params, generator)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.env import FunctionalEnv, TimeStep, autoreset_step
from ..core.graph import device_const
from ..core.spaces import Box, DictSpace

__all__ = ["CheckError", "Error", "check_timestep", "checked_reset",
           "checked_step", "validate_batch_rollout"]


class CheckError(RuntimeError):
    """A failed check, raised by :meth:`Error.throw`."""


@dataclasses.dataclass
class Error:
    """The device-side error word of a run of checks: ``code`` (0-d
    int32) is 0 when every check held, else ``k``: ``messages[k - 1]``
    names the first check that failed."""

    code: torch.Tensor
    messages: tuple[str, ...]

    def get(self) -> str | None:
        """The first failed check's message, or None (reads the host)."""
        k = int(self.code)
        return self.messages[k - 1] if k else None

    def throw(self) -> None:
        """Raises :class:`CheckError` with the first failed check's
        message; the one host read of the checks."""
        msg = self.get()
        if msg is not None:
            raise CheckError(msg)

    def merge(self, later: "Error") -> "Error":
        """This error where it holds a failure, else ``later``'s: the first
        failure of the two runs of checks, on the device. The messages of
        ``later`` join this table (its codes renumbered by a lookup on
        the device where the tables differ)."""
        if later.messages == self.messages:
            code = later.code
            messages = self.messages
        else:
            messages = self.messages + tuple(
                m for m in later.messages if m not in self.messages)
            lookup = device_const(
                [0] + [messages.index(m) + 1 for m in later.messages],
                later.code.device, torch.int32)
            code = torch.take(lookup, later.code.long())
        return Error(torch.where(self.code == 0, code, self.code), messages)


class _Checks:
    """Builds an :class:`Error`: :meth:`check` keeps each check's 0-d
    verdict; :meth:`error` stacks them and takes the first failure's
    message number on the device (a message's number is its place in the
    table), a few kernels for the whole run of checks."""

    def __init__(self):
        self.oks: list[torch.Tensor] = []
        self.codes: list[int] = []
        self.messages: list[str] = []

    def check(self, ok: torch.Tensor, msg: str) -> None:
        if msg not in self.messages:
            self.messages.append(msg)
        self.oks.append(ok)
        self.codes.append(self.messages.index(msg) + 1)

    def error(self) -> Error:
        ok = torch.stack(self.oks)
        codes = device_const(self.codes, ok.device, torch.int32)
        # argmax takes the first of equal values: the first failed check;
        # torch.take, as indexing by a 0-d tensor reads it on the host
        first = torch.take(codes, (~ok).to(torch.int32).argmax())
        return Error(torch.where(ok.all(), 0, first).to(torch.int32),
                     tuple(self.messages))


def _tensor(x, device) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x, device=device)


def _leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order: dict keys
    sorted, sequences and dataclass fields in order, None empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


def check_timestep(ts: TimeStep, obs_space: Any = None) -> Error:
    """The checks over one batched TimeStep, in the JAX module's order;
    with ``obs_space`` also the bounds. Reads nothing on the host."""
    device = ts.reward.device if torch.is_tensor(ts.reward) else None
    checks = _Checks()
    for i, leaf in enumerate(_leaves(ts.obs)):
        leaf = _tensor(leaf, device)
        if leaf.is_floating_point():
            checks.check(torch.isfinite(leaf).all(),
                         f"non-finite value in obs leaf {i}")
    checks.check(torch.isfinite(_tensor(ts.reward, device)).all(),
                 "non-finite reward")
    for name, val in sorted(ts.info.items()):
        val = _tensor(val, device)
        if val.is_floating_point():
            checks.check(torch.isfinite(val).all(),
                         f"non-finite info[{name}]")
    for flag in (ts.terminated, ts.truncated):
        flag = _tensor(flag, device)
        checks.check(((flag == 0) | (flag == 1)).all(),
                     "terminated/truncated not boolean")
    if obs_space is not None:
        _check_bounds(checks, ts.obs, obs_space, "obs", device)
    return checks.error()


def _check_bounds(checks: _Checks, obs: Any, space: Any, label: str,
                  device) -> None:
    """Recursive bounds check: Box leaves against their declared ranges,
    DictSpace entries walked by key. Structured spaces the walk cannot
    interpret raise rather than silently skipping."""
    if isinstance(space, DictSpace):
        if not isinstance(obs, dict):
            # the JAX walk fails here too: jnp arrays take no string index
            raise TypeError(f"check_bounds: {label} is a "
                            f"{type(obs).__name__}, not the dict of "
                            f"{space!r}")
        for name, sub in space.spaces.items():
            _check_bounds(checks, obs[name], sub, f"{label}[{name}]", device)
        return
    if isinstance(space, Box):
        x = _tensor(obs, device)
        lo, hi = _slack_bounds(space, x.dtype, x.device)
        checks.check(((x >= lo) & (x <= hi)).all(),
                     f"{label} outside declared observation-space bounds")
        return
    if hasattr(space, "nvec"):        # MultiDiscrete
        x = _tensor(obs, device)
        nvec = device_const(space.nvec, x.device, x.dtype)
        checks.check(((x >= 0) & (x < nvec)).all(),
                     f"{label} outside MultiDiscrete range")
        return
    if hasattr(space, "n"):           # Discrete
        x = _tensor(obs, device)
        checks.check(((x >= space.start) & (x < space.start + space.n)).all(),
                     f"{label} outside Discrete range")
        return
    raise TypeError(
        f"check_bounds requested but space type {type(space).__name__} "
        f"for {label} is unsupported")


_BOUNDS: dict = {}


def _slack_bounds(space: Box, dtype, device) -> tuple:
    """``(low - slack, high + slack)`` of a Box in ``dtype`` on ``device``,
    slack ``1e-5 * (1 + |low| + |high|)`` for float32 rounding at the
    bounds, in the JAX module's arithmetic; made once per bounds, type
    and device and kept, as ``device_const`` keeps a constant, so a
    capture reads them."""
    key = (space.low.tobytes(), space.high.tobytes(), space.shape,
           str(dtype), str(torch.device(device)))
    out = _BOUNDS.get(key)
    if out is None:
        lo = device_const(space.low, device, dtype)
        hi = device_const(space.high, device, dtype)
        slack = 1e-5 * (1.0 + lo.abs() + hi.abs())
        out = _BOUNDS[key] = (lo - slack, hi + slack)
    return out


def checked_reset(env: FunctionalEnv, check_bounds: bool = False
                  ) -> Callable:
    """Returns ``reset(params, generator, batch) -> ((state, ts), Error)``:
    ``env.reset`` and its TimeStep checked."""

    def run(params, generator, batch):
        state, ts = env.reset(params, generator, batch)
        space = env.observation_space(params) if check_bounds else None
        return (state, ts), check_timestep(ts, space)

    return run


def checked_step(env: FunctionalEnv, check_bounds: bool = False
                 ) -> Callable:
    """Returns ``step(params, state, action, generator) -> ((state, ts),
    Error)``: ``env.step`` and its TimeStep checked."""

    def run(params, state, action, generator=None):
        new_state, ts = env.step(params, state, action, generator)
        space = env.observation_space(params) if check_bounds else None
        return (new_state, ts), check_timestep(ts, space)

    return run


def validate_batch_rollout(env: FunctionalEnv, params: Any,
                           generator: torch.Generator, batch: int = 32,
                           steps: int = 16, check_bounds: bool = False,
                           armed: bool = True) -> torch.Tensor:
    """Rolls a random-action batch of ``batch`` envs for ``steps`` steps
    through the autoreset step, checks every TimeStep (the reset's too),
    keeps the first failure on the device and reads it once at the end:
    raises :class:`CheckError` on the first NaN or bounds violation.
    Returns the sum of every reward of the rollout (a 0-d tensor).
    ``armed`` False runs the same rollout, with the same draws, unchecked
    (the yardstick of what the checks cost)."""
    from ..core.rollout import random_policy

    policy = random_policy(env, params, batch)
    step = autoreset_step(env)
    space = env.observation_space(params) if check_bounds else None
    state, ts = env.reset(params, generator, batch)
    err = check_timestep(ts, space) if armed else None
    obs, rewards = ts.obs, []
    for _ in range(steps):
        action = policy(None, obs, generator)
        state, ts = step(params, state, action, generator)
        if armed:
            err = err.merge(check_timestep(ts, space))
        obs = ts.obs
        rewards.append(ts.reward)
    total = torch.stack(rewards).sum()
    if armed:
        err.throw()
    return total
