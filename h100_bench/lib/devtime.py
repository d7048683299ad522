"""Device time on the card: CUDA events around a kernel's C entry point,
and the reduction of a ``torch.profiler`` trace to the device's busy time,
its kernels by name and its idle gaps."""
from __future__ import annotations

import contextlib

SPIN_CYCLES = 2_000_000     # about 1 ms on an H100: covers the host's enqueue


@contextlib.contextmanager
def timed_launches(launch: str, spans: list, device=None):
    """Wraps the C entry point ``launch`` (a ``*_launch`` function of a
    kernel library the program has bound) so that each call appends its
    (start, end) CUDA events to ``spans``. A spin kernel queued before the
    start event keeps the card busy while the host enqueues the launch, so
    no host time falls between the events. Times nothing unless
    ``device`` is a CUDA device."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        yield spans
        return
    from sustaingym_tpu_torch.ops.cuda import wrap
    libs = [lib for lib in wrap._BOUND.values() if launch in vars(lib)]
    if len(libs) != 1:
        raise RuntimeError(f"no bound kernel library declares {launch}")
    lib, real = libs[0], getattr(libs[0], launch)

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        err = real(*args)
        end.record()
        spans.append((start, end))
        return err

    setattr(lib, launch, timed)
    try:
        yield spans
    finally:
        setattr(lib, launch, real)


def span_ms(spans: list) -> list[float]:
    """The device milliseconds of each (start, end) pair (synchronises)."""
    import torch
    if not spans:
        return []
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in spans]


def activities(device) -> list:
    """The profiler's activities: the host's, and the card's on a card."""
    from torch.profiler import ProfilerActivity
    if device.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def kernel_intervals(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every kernel, copy and set the profiler
    saw on the device, sorted by start. The host's ``record_function``
    ranges, which the trace mirrors onto the device's timeline, are left
    out: they are not device work."""
    host = {e[2] for e in host_intervals(prof)}
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) is None:
            continue
        if e.device_type.name != "CUDA" or e.time_range.end <= 0 \
                or e.name in host:
            continue
        out.append((e.time_range.start, e.time_range.end, e.name))
    out.sort()
    return out


def host_intervals(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of the host's events."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if getattr(e, "device_type", None) is not None
            and e.device_type.name == "CPU"]


def union_busy(kernels, t0: float, t1: float) -> tuple[float, list]:
    """Microseconds inside [t0, t1] in which any kernel ran (overlaps
    counted once), and the idle gaps [(start, end)] between them."""
    busy, gaps, cur = 0.0, [], t0
    for s, e, _ in kernels:
        s, e = max(s, t0), min(e, t1)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            busy += e - s
        else:
            busy += e - cur
        cur = e
    if cur < t1:
        gaps.append((cur, t1))
    return busy, gaps


def breakdown(prof, t0: float, t1: float) -> dict:
    """The traced window [t0, t1] (profiler microseconds): busy seconds,
    the ten kernels with the most device time and the ten longest idle
    gaps, each named by the innermost host event under its middle."""
    kernels = kernel_intervals(prof)
    busy, gaps = union_busy(kernels, t0, t1)
    by_name: dict[str, float] = {}
    for s, e, name in kernels:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    hosts = host_intervals(prof)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        under = [h for h in hosts if h[0] <= mid <= h[1]]
        name = (min(under, key=lambda h: h[1] - h[0])[2] if under
                else "no host event")
        named.append([name, (e - s) * 1e-6])
    return {"busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "device_ops": [[n, v] for n, v in top], "idle_gaps": named,
            "kernels": len(kernels)}
