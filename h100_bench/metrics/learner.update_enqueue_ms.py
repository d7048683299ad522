"""learner.update_enqueue_ms: the host time the PPO update takes to queue
its work inside whole train steps: the program's ``ppo.update`` span
(children of ``ppo.step``), host clock from entry to exit with nothing
synchronised, mean ms over the steps of the program's traced pass
(``lib/program.py``, tracing alone)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.mean([s["host_ms"] for s in program.spans(
        p["light"], "ppo.update", "ppo.step")])
