"""graphs.replays_per_step: CUDA graph replays a train step, the sum of the
program's ``graphs.replays.<slot>`` counters over the steps of its traced
pass (``lib/program.py``, tracing alone)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.counted(p["light"], "graphs.replays") / p["units"]
