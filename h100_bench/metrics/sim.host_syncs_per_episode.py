"""sim.host_syncs_per_episode: the host's reads of device values an
episode call, the sum of the program's ``host_syncs.<site>`` counters over
the episodes of its traced pass (``lib/program.py``, tracing alone)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.counted(p["light"], "host_syncs") / p["units"]
