"""The program's own spans and counters (``sustaingym_tpu_torch/core/
trace.py``) over a pass that each driver's traced run appends to its
profiled window, for the per-layer metrics that read them.

A traffic driver gives the pass what it needs of the driver:

- ``unit()``: one unit of its work (a train step, an episode),
  synchronised as its measured window calls it;
- ``UNITS``: the traffic mix's key that counts the units of a pass
  (``trace_steps``, ``trace_episodes``);
- ``graphs``: the program's ``Graphs`` whose pool the pass reports, or
  None where it has none;
- ``mix`` and ``device``.

Its ``traced()`` calls :func:`run` on itself once its own profiled
window (and its timed launches, where it has them) is over, and returns
the result under ``"program"``; ``cell.run_cell`` copies it into the
``ctx`` that the readers get, where :func:`of` finds it. The pass:

1. ``n`` units under ``trace.recording()`` alone: the spans and counters;
2. one more unit under ``trace.recording()`` and ``torch.profiler`` (one:
   the profiler's trace of a train step holds ~170,000 kernels, and
   reading it back takes ~10 s): on a card, the device's idle time inside
   each host range of a program span (``devtime.union_busy`` over the
   range), and the profiler's count of ``cudaGraphLaunch`` calls, against
   which the program's replay counters check that the trace lost no
   launch.

The result: ``units``, ``light`` (pass 1's snapshot), ``profiled`` (pass
2's ``units``, ``snapshot``, ``idle_ms`` {span name: [ms of each range]}
or None off a card, ``graph_launches``) and ``pool_bytes`` (the driver's
``graphs.pool_bytes`` after the pass, None without graphs). It is None
where the program has no tracer (a checkout older than it): the readers
then return None.
"""
from __future__ import annotations

import bisect

from h100_bench.lib import devtime


def run(driver) -> dict | None:
    """The program's pass on ``driver`` (see the module's docstring)."""
    try:
        from sustaingym_tpu_torch.core import trace
    except ImportError:
        return None
    n = driver.mix[driver.UNITS]
    light = _light(trace, driver.unit, n, driver.device)
    profiled = _profiled(trace, driver.unit, 1, driver.device)
    graphs = driver.graphs
    return {"units": n, "light": light, "profiled": profiled,
            "pool_bytes": None if graphs is None else graphs.pool_bytes}


def of(ctx: dict) -> dict | None:
    """The program's pass of the run whose readers' ``ctx`` this is."""
    return ctx.get("program")


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
