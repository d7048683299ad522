"""learner.update_idle_ms: the card's idle time inside the host ranges of
the program's ``ppo.update`` spans, ms a train step, from the profiler's
trace of the program's profiled step (``lib/program.py``): each range's
length less the union of kernel intervals in it. None where the trace
holds fewer ``cudaGraphLaunch`` calls than the program's
``graphs.replays.*`` counters count in the same pass (the profiler lost
launches, so its idle time would be too high)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not p["profiled"]["idle_ms"]:
        return None
    prof = p["profiled"]
    if prof["graph_launches"] < program.counted(prof["snapshot"],
                                                "graphs.replays"):
        return None
    ranges = prof["idle_ms"].get("ppo.update")
    return sum(ranges) / prof["units"] if ranges else None
