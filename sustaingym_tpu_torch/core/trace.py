"""Spans and counters inside the port's hot paths: the PPO train step, its
CUDA graph replays, the EV episode kernels' callers and the market's
lockstep rollout.

Tracing is off unless code turns it on, and nothing else (no option, no
environment variable) does::

    with trace.recording() as rec:
        train_step(carry, generator)
    snap = rec.snapshot()

While it is off, :func:`span` returns one shared no-op context and
:func:`count` returns at once; both test one module-level reference.

While a recording is open, each span records its name, its parent span,
the step it belongs to (the index of its outermost span: a train step, or
an episode called on its own) and the host's ``perf_counter_ns`` at entry
and exit. A span given a CUDA ``device`` also records a pair of timing
CUDA events on that device's current stream; they are read only by
:meth:`Recording.snapshot`, which synchronises once. No span synchronises
the card. Each span also opens a ``torch.profiler.record_function`` range
of its name, so that under the profiler the device trace's host ranges
are the program's spans.

Counters are dotted names: ``graphs.replays.<slot>`` (the replays of each
:class:`core.graph.Graphs` slot), ``host_syncs.<site>`` (each read of
a device value by the host on the traced paths; the market's lockstep
rollout has none) and ``market.solves``, ``market.pdhg_iters`` (the SCED
solves of the market's lockstep episodes and their PDHG iterations,
counted on the host from the lockstep budgets: 288 and 200 + 287 x 40 =
11,680 an episode at the defaults). The snapshot also holds
the ``launches`` that each kernel wrapper registered with
:func:`core.graph.count_launches` added while the recording was open.

Span names: ``ppo.step`` (device), its children ``ppo.rollout``,
``ppo.score``, ``ppo.update`` (device) and ``ppo.update.perms`` (the
update's permutations, run eagerly); ``graphs.replay`` (a
:class:`Graphs` call's input copies and replays, tagged with its slot);
``ev.fused_rollout`` (device, one EV episode of a fused kernel) and its
child ``ev.prelaunch``, from the episode's entry to its kernel's launch
(the reset day draws, the seed read, the range check), closed by the
kernel wrapper (:func:`end`); ``market.start`` (host: an eager episode
start of the market's ``batch_unroll``, the reset draws, state and obs)
and ``market.episode`` (device: one episode's step loop, a graph replay
with its input copies where the rollout has graphs).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["Recording", "active", "begin", "count", "end", "label",
           "recording", "span"]

# the open recording; None while tracing is off
_REC: Recording | None = None


class _Off:
    """The shared no-op span of tracing off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "step", "tag", "t0", "t1", "events",
                 "range")

    def __init__(self, name, parent, step, tag):
        self.name, self.parent, self.step, self.tag = name, parent, step, tag
        self.t0 = self.t1 = None
        self.events = self.range = None


class _Open:
    """The context of one span while a recording is open."""

    __slots__ = ("rec", "args", "index")

    def __init__(self, rec, args):
        self.rec, self.args = rec, args

    def __enter__(self):
        self.index = self.rec.open(*self.args)

    def __exit__(self, *exc):
        self.rec.close(self.index)
        return False


class Recording:
    """What one :func:`recording` saw: spans, counters and the kernel
    wrappers' launch counts at its start."""

    def __init__(self):
        from .graph import counted_wrappers
        self.spans: list[_Span] = []
        self.stack: list[int] = []      # the open spans, innermost last
        self.counters: dict[str, int] = defaultdict(int)
        self.steps = 0
        self.launches0 = {w: w.launches for w in counted_wrappers()}

    def open(self, name: str, device=None, tag=None) -> int:
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            step, self.steps = self.steps, self.steps + 1
        else:
            step = self.spans[parent].step
        s = _Span(name, parent, step, tag)
        s.range = torch.autograd.profiler.record_function(name)
        s.range.__enter__()
        if device is not None and device.type == "cuda" \
                and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            s.events = (device, start, torch.cuda.Event(enable_timing=True))
        self.spans.append(s)
        self.stack.append(len(self.spans) - 1)
        s.t0 = time.perf_counter_ns()
        return len(self.spans) - 1

    def close(self, index: int) -> None:
        """Closes span ``index`` and any span still open inside it (one
        that an exception left open, or that :func:`end` never closed)."""
        if index not in self.stack:
            return
        t = time.perf_counter_ns()
        while self.stack:
            i = self.stack.pop()
            s = self.spans[i]
            s.t1 = t
            if s.events is not None:
                dev, _, stop = s.events
                stop.record(torch.cuda.current_stream(dev))
            s.range.__exit__(None, None, None)
            s.range = None
            if i == index:
                return

    def snapshot(self) -> dict:
        """Everything recorded, as one JSON-able dict: ``spans`` (each
        ``name``, ``parent`` (an index into the list, or None), ``step``,
        ``tag``, ``t0_ns`` / ``t1_ns`` (host ``perf_counter_ns``),
        ``host_ms``, ``self_ms`` (``host_ms`` less its children's) and
        ``device_ms`` (the span's CUDA events, or None)), ``counters`` and
        ``launches`` (each counted kernel wrapper's launches since the
        recording began). Synchronises once where a span holds events; a
        span still open has None for its times."""
        if any(s.events is not None for s in self.spans):
            torch.cuda.synchronize()
        covered = [0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None and s.t1 is not None:
                covered[s.parent] += s.t1 - s.t0
        spans = []
        for s, kids in zip(self.spans, covered):
            done = s.t1 is not None
            dev = None
            if done and s.events is not None:
                dev = s.events[1].elapsed_time(s.events[2])
            spans.append({
                "name": s.name, "parent": s.parent, "step": s.step,
                "tag": None if s.tag is None else label(s.tag),
                "t0_ns": s.t0, "t1_ns": s.t1,
                "host_ms": (s.t1 - s.t0) * 1e-6 if done else None,
                "self_ms": (s.t1 - s.t0 - kids) * 1e-6 if done else None,
                "device_ms": dev})
        from .graph import counted_wrappers
        launches = {w.__name__: w.launches - self.launches0.get(w, 0)
                    for w in counted_wrappers()}
        return {"spans": spans, "counters": dict(self.counters),
                "launches": launches}


@contextlib.contextmanager
def recording():
    """Turns tracing on for the block and yields its :class:`Recording`
    (read it with ``snapshot()``, inside the block or after it). Spans
    still open at its end are closed. Recordings do not nest."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a trace recording is already open")
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        if rec.stack:
            rec.close(rec.stack[0])
        _REC = None


def active() -> Recording | None:
    """The open recording, or None while tracing is off."""
    return _REC


def span(name: str, device=None, tag=None):
    """A context that records span ``name`` while a recording is open;
    ``device`` (a CUDA ``torch.device``) adds its device time, ``tag`` a
    label (:func:`label`)."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Open(rec, (name, device, tag))


def begin(name: str) -> None:
    """Opens the host span ``name``, to be closed by :func:`end` in another
    function (or with its parent)."""
    rec = _REC
    if rec is not None:
        rec.open(name)


def end(name: str) -> None:
    """Closes the innermost open span if it is named ``name``."""
    rec = _REC
    if rec is not None and rec.stack \
            and rec.spans[rec.stack[-1]].name == name:
        rec.close(rec.stack[-1])


def count(name: str, n: int = 1, key=None) -> None:
    """Adds ``n`` to counter ``name`` (``name.<label(key)>`` with a
    ``key``) while a recording is open."""
    rec = _REC
    if rec is None:
        return
    rec.counters[name if key is None else f"{name}.{label(key)}"] += n


def label(key) -> str:
    """A dotted name for a graph slot: a string as it is; else the
    strings, integers and booleans of a tuple, and its functions' names,
    joined by dots (shapes and other objects left out)."""
    if isinstance(key, str):
        return key
    parts = []
    for p in key if isinstance(key, tuple) else (key,):
        if isinstance(p, (str, bool, int)):
            parts.append(str(p))
        elif callable(p) and hasattr(p, "__name__"):
            parts.append(p.__name__)
    return ".".join(parts) or type(key).__name__
