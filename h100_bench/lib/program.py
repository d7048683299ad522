"""The program's own spans and counters (``sustaingym_tpu_torch/core/
trace.py``) over a pass appended to a traced run, for the per-layer
metrics that read them.

A metric's reader gets the run's ``ctx`` and no handle on the run's
program, which the run has released before its readers. So the first
reader that asks (:func:`of`) builds the cell's program again: a new
driver of the cell's traffic mix, of the run's own class, configuration,
mix, seed and device (read from the frame of the :func:`cell.run_cell`
call that is reading its metrics), set up untraced. Its pass runs after
the run's traced window, comparison and earlier readers, so nothing of
theirs changes, and then:

1. ``n`` units (``trace_steps`` whole train steps, ``trace_episodes``
   episodes, each synchronised as the cell's window calls them) under
   ``trace.recording()`` alone: the spans and counters;
2. one more unit under ``trace.recording()`` and ``torch.profiler`` (one:
   the profiler's trace of a train step holds ~170,000 kernels, and
   reading it back takes ~10 s): on a card, the device's idle time inside
   each host range of a program span (``devtime.union_busy`` over the
   range), and the profiler's count of ``cudaGraphLaunch`` calls, against
   which the program's replay counters check that the trace lost no
   launch.

The result is kept in ``ctx["program"]``: ``units``, ``light`` (pass 1's
snapshot), ``profiled`` (pass 2's ``units``, ``snapshot``, ``idle_ms``
{span name: [ms of each range]} or None off a card, ``graph_launches``)
and ``pool_bytes`` (the trainer's ``Graphs.pool_bytes`` after the pass,
None without one).
It is None where ``ctx`` is not a run's or the program has no tracer (a
checkout older than it): the readers then return None.
"""
from __future__ import annotations

import bisect
import gc
import sys

from h100_bench.lib import devtime

# each driver's unit of work, and the mix's count of units a pass
UNITS = {"ppo_train": "trace_steps", "sim_episodes": "trace_episodes"}


def of(ctx: dict) -> dict | None:
    """The program's pass for this run (run once, kept in ``ctx``)."""
    if "program" in ctx:
        return ctx["program"]
    ctx["program"] = None
    run = _run_args() if {"config", "mix"} <= set(ctx) else None
    if run is None or ctx["mix"]["driver"] not in UNITS:
        return None
    try:
        from sustaingym_tpu_torch.core import trace
    except ImportError:
        return None
    import torch
    driver, seed, device = run
    mix = ctx["mix"]
    fresh = type(driver)(ctx["config"], mix, seed, device)
    fresh.setup(False)
    try:
        # each unit synchronised, as the cell's window calls them
        if mix["driver"] == "ppo_train":

            def unit():
                fresh.step(fresh.carry, fresh.gen)
                _sync(fresh.device)
            graphs = fresh.step.graphs
        else:

            def unit():
                fresh.env.fused_rollout(fresh.params, mix["batch"],
                                        mix["episode_steps"],
                                        generator=fresh.gen)
                _sync(fresh.device)
            graphs = None
        n = mix[UNITS[mix["driver"]]]
        ctx["program"] = {
            "units": n, "light": _light(trace, unit, n, fresh.device),
            "profiled": _profiled(trace, unit, 1, fresh.device),
            "pool_bytes": None if graphs is None else graphs.pool_bytes}
    finally:
        fresh.release()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return ctx["program"]


def _run_args():
    """(driver, seed, device) of the ``cell.run_cell`` call up the stack,
    or None."""
    from h100_bench.lib import cell
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is cell.run_cell.__code__:
            return f.f_locals["driver"], f.f_locals["seed"], \
                f.f_locals["device"]
        f = f.f_back
    return None


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _light(trace, unit, n: int, device) -> dict:
    _sync(device)
    with trace.recording() as rec:
        for _ in range(n):
            unit()
    return rec.snapshot()


def _profiled(trace, unit, n: int, device) -> dict:
    from torch.profiler import profile, record_function
    _sync(device)
    with profile(activities=devtime.activities(device)) as prof:
        with trace.recording() as rec, record_function("bench.program"):
            for _ in range(n):
                unit()
            _sync(device)
    snap = rec.snapshot()
    hosts = devtime.host_intervals(prof)
    t0, t1 = next((s, e) for s, e, name in hosts if name == "bench.program")
    inside = [h for h in hosts if t0 <= h[0] and h[1] <= t1]
    names = {s["name"] for s in snap["spans"]}
    idle = None
    if device.type == "cuda":
        merged = _merged(devtime.kernel_intervals(prof))
        starts = [m[0] for m in merged]
        idle = {}
        for s, e, name in inside:
            if name in names:
                lo = max(0, bisect.bisect_right(starts, s) - 1)
                hi = bisect.bisect_left(starts, e)
                busy, _ = devtime.union_busy(merged[lo:hi], s, e)
                idle.setdefault(name, []).append((e - s - busy) * 1e-3)
    return {"units": n, "snapshot": snap, "idle_ms": idle,
            "graph_launches": sum(1 for h in inside
                                  if h[2] == "cudaGraphLaunch")}


def _merged(kernels) -> list[tuple[float, float, str]]:
    """The union of kernel intervals as disjoint (start, end, "") sorted
    by start: ``union_busy`` over a slice of them counts each instant
    once."""
    out: list[list] = []
    for s, e, _ in kernels:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e, "") for s, e in out]


def spans(snap: dict, name: str, parent: str | None = None) -> list[dict]:
    """The closed spans ``name`` of a snapshot, those whose parent span
    is named ``parent`` where one is given."""
    out = []
    for s in snap["spans"]:
        if s["name"] != name or s["host_ms"] is None:
            continue
        if parent is not None and (
                s["parent"] is None
                or snap["spans"][s["parent"]]["name"] != parent):
            continue
        out.append(s)
    return out


def counted(snap: dict, prefix: str) -> int:
    """The sum of the counters named ``<prefix>.*``."""
    return sum(v for k, v in snap["counters"].items()
               if k.startswith(prefix + "."))


def mean(values: list) -> float | None:
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None
