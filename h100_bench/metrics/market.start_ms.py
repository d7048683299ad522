"""market.start_ms: the host time of one eager episode start of the
market's lockstep rollout (the reset day draws, the reset state and obs):
the program's ``market.start`` span, mean ms over the starts of its
traced pass (``lib/program.py``, tracing alone; an episode call starts
its episode and, at its end, the next one)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.mean([s["host_ms"] for s in program.spans(
        p["light"], "market.start")])
