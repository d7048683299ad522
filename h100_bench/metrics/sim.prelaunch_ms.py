"""sim.prelaunch_ms: the host time from an episode call's entry to its
kernel's launch (the reset day draws, the kernel seed's read, the days'
range check): the program's ``ev.prelaunch`` span, mean ms over the
episodes of its traced pass (``lib/program.py``, tracing alone)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.mean([s["host_ms"] for s in program.spans(
        p["light"], "ev.prelaunch")])
