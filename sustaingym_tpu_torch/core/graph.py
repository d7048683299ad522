"""CUDA graphs: the port's counterpart of ``jax.jit`` for loops of small
launches.

The JAX package runs a train step as one jitted program, its episode loops
and minibatch epochs under ``lax.scan``. PyTorch runs eagerly, so the
port's step loops issue every small kernel from the host. On a CUDA device
:class:`Graphs` captures such a loop once and replays it afterwards: one
``cudaGraphLaunch`` in place of thousands of ``cudaLaunchKernel`` calls.
On the CPU it calls the function, so CPU results never depend on it.

A captured function ``fn(*inputs)`` takes trees (tensors, dicts, lists,
tuples, dataclasses of tensors) and returns a tree of tensors. It may also
read tensors that outlive the graph (env params, policy weights updated in
place, :func:`device_const` constants) and draw from the generators it is
given. It must not synchronise with the host (no ``.item()``, no
``torch.tensor`` from host data on the device): a capture that meets such a
call raises, and nothing here catches it.

Launch counters: a kernel wrapper registered by :func:`count_launches`
adds one to its ``launches`` attribute where it launches its kernel. A
capture launches nothing, so :class:`Graphs` takes back what the wrappers
added while it captured and adds it again at every replay: ``launches``
counts the kernel's launches on the card, the warm-up's and each replay's
included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from . import trace

__all__ = ["Graphs", "count_launches", "counted_wrappers", "device_const",
           "device_index", "tree_leaves"]

# the kernel wrappers whose ``launches`` count their kernel's launches
_COUNTED: list[Callable] = []


def count_launches(wrapper: Callable) -> Callable:
    """Registers ``wrapper``, a kernel wrapper that adds one to its
    ``launches`` attribute where it launches its kernel, and sets that
    count to 0. A :class:`Graphs` capture takes back what the registered
    wrappers added while it captured and adds it at every replay."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def counted_wrappers() -> list[Callable]:
    """The kernel wrappers registered by :func:`count_launches` (those of
    the kernel modules imported so far)."""
    return list(_COUNTED)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of ``tree`` in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return []


def _tree_clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_clone(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


@dataclasses.dataclass
class _Captured:
    graph: Any               # torch.cuda.CUDAGraph
    inputs: tuple            # the static input buffers
    outputs: Any             # the static outputs, rewritten by each replay
    fn: Callable             # kept alive: it holds what the graph reads
    state: tuple             # kept alive: the tensors the graph updates
    launches: tuple          # (wrapper, kernel launches) of one replay


class Graphs:
    """The CUDA graphs of one trainer, or of one caller of a lockstep
    rollout, sharing one memory pool.

    ``graphs(key, fn, *inputs, generators=(), state=(), repeat=1)`` calls
    ``fn(*inputs)`` ``repeat`` times and returns the last result (a ``fn``
    that advances a counter of its own, such as one minibatch update of
    an epoch loop, replays ``repeat`` times from one copy of its inputs).
    On a CUDA device the first call with ``key`` in its slot:

    1. copies ``inputs`` into static buffers;
    2. warms ``fn`` up once on a side stream (lazy initialisation of
       cuBLAS, the kernels' libraries, the optimizer state), then restores
       ``generators`` and ``state`` (tensors that ``fn`` updates in place:
       weights, optimizer state), so warm-up leaves no trace;
    3. captures ``fn`` with each generator registered with the graph, so
       every replay draws from the generator's current offset and advances
       it as the eager calls would, then restores them again.

    Every call (the first too) copies its inputs into the static buffers
    (skipped for a tensor that is its buffer), replays the graph
    ``repeat`` times and returns its static outputs: the next replay of
    the same graph overwrites them, so the caller consumes or clones them
    first. The graphs of one ``Graphs`` share a pool, so a graph may hold
    its outputs in the scratch memory of one captured before it: the
    caller consumes each graph's outputs before a graph captured earlier
    runs again.

    ``key`` names everything ``fn`` depends on besides its inputs' values
    (shapes, the env, the policy, the generator; objects named by ``id``
    are kept alive by the capture, so their ids are not reused while it
    lives). A ``slot`` holds one capture: a call with another key for a
    slot that holds one drops it (its graph, and its memory once the
    caller lets go of its outputs) and captures anew. ``slot`` defaults to
    ``key``. :meth:`clear` drops every capture and the pool.

    Each replay adds to the ``launches`` of the wrappers registered by
    :func:`count_launches` the launches it holds; the capture itself adds
    nothing. ``warmup_s`` sums the host seconds of the warm-ups,
    ``capture_s`` those of the captures and instantiations; ``captures``
    counts the graphs captured; ``pool_bytes``, read after each capture,
    is the memory the graphs hold on the card: the segments of their pool
    (as the allocator reports them) and the static input buffers of the
    captures alive. Under a
    :func:`core.trace.recording` each call's input copies and replays are
    a ``graphs.replay`` span tagged with the slot, and its replays add to
    the counter ``graphs.replays.<slot>``. On the CPU every call is
    ``fn(*inputs)``.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures = 0
        self.warmup_s = self.capture_s = 0.0
        self.pool_bytes = 0
        self._pool = None
        self._captured: dict[Any, tuple[Any, _Captured]] = {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def __call__(self, key, fn: Callable, *inputs, generators=(),
                 state=(), repeat: int = 1, slot=None) -> Any:
        if not self.on_card:
            for _ in range(repeat):
                out = fn(*inputs)
            return out
        slot = key if slot is None else slot
        held = self._captured.pop(slot, None)
        fresh = held is None or held[0] != key
        if fresh:
            del held
            if not self._captured:
                # no graph holds the pool now: it is released, and a
                # capture into its handle fails inside the allocator
                self._pool = None
            entry = self._capture(fn, inputs, tuple(generators),
                                  tuple(state))
        else:
            entry = held[1]
        self._captured[slot] = (key, entry)
        if fresh:
            self.pool_bytes = self._held_bytes()
        with trace.span("graphs.replay", tag=slot):
            for dst, src in zip(tree_leaves(entry.inputs),
                                tree_leaves(inputs)):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
            for _ in range(repeat):
                entry.graph.replay()
        trace.count("graphs.replays", repeat, key=slot)
        for wrapper, n in entry.launches:
            wrapper.launches += n * repeat
        return entry.outputs

    def _held_bytes(self) -> int:
        """The bytes of the pool's segments and of the live captures'
        static inputs."""
        pool = tuple(self._pool)
        segments = sum(seg["total_size"]
                       for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == pool)
        return segments + sum(x.numel() * x.element_size()
                              for _, e in self._captured.values()
                              for x in tree_leaves(e.inputs))

    def clear(self):
        """Drops every capture and the pool: the next call of each slot
        captures anew."""
        self._captured.clear()
        self._pool = None

    def _capture(self, fn, inputs, generators, state) -> _Captured:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        static = _tree_clone(inputs)
        gen_states = [g.get_state() for g in generators]
        saved = [s.detach().clone() for s in state]

        def restore():
            for g, s in zip(generators, gen_states):
                g.set_state(s)
            with torch.no_grad():
                for dst, src in zip(state, saved):
                    dst.copy_(src)

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        restore()
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.warmup_s += t1 - t0
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        counts = [w.launches for w in _COUNTED]
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = fn(*static)
        restore()
        launches = []
        for w, n in zip(_COUNTED, counts):
            if w.launches != n:
                launches.append((w, w.launches - n))
                w.launches = n
        if self._pool is None:
            self._pool = graph.pool()
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t1
        self.captures += 1
        return _Captured(graph=graph, inputs=static, outputs=outputs, fn=fn,
                         state=state, launches=tuple(launches))


_CONSTS: dict[Any, torch.Tensor] = {}


def device_const(value, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)``, made once per value,
    type and device and kept: a host-to-device copy cannot be captured in
    a graph, and a kept constant is made at warm-up, before the capture."""
    arr = np.asarray(value)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(dtype),
           str(torch.device(device)))
    out = _CONSTS.get(key)
    if out is None:
        out = torch.as_tensor(arr, dtype=dtype, device=device)
        _CONSTS[key] = out
    return out


def device_index(indices, device) -> torch.Tensor:
    """An int64 index tensor of ``indices`` on ``device``, kept as
    :func:`device_const` keeps it: indexing by a Python list copies the
    list to the device at every call."""
    return device_const(np.asarray(indices, dtype=np.int64), device,
                        torch.long)
