"""graphs.pool_gib: the memory the trainer's CUDA graphs took at their
warm-ups and captures, GiB: the program's ``Graphs.pool_bytes`` (the rise
of the allocator's reserved memory across each), for the trainer of the
program's traced pass (``lib/program.py``)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None or p["pool_bytes"] is None:
        return None
    return p["pool_bytes"] / 2 ** 30
