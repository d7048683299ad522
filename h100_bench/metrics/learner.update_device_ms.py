"""learner.update_device_ms: the device time of the PPO update inside whole
train steps: the program's ``ppo.update`` span (children of ``ppo.step``),
its CUDA events, mean ms over the steps of the program's traced pass
(``lib/program.py``, tracing alone)."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.mean([s["device_ms"] for s in program.spans(
        p["light"], "ppo.update", "ppo.step")])
