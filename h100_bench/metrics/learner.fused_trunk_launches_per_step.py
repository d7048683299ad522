"""learner.fused_trunk_launches_per_step: the PPO trunk's glue passes a
train step, the launches that the program's ``ppo_trunk`` wrapper
(``ops/cuda/ppo_trunk.py``: one a hidden layer and direction) counted over
the steps of its traced pass (``lib/program.py``, tracing alone), replays
of the captured minibatches and scoring included. None where the program
has no such wrapper."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    launches = p["light"].get("launches", {}).get("ppo_trunk")
    if launches is None:
        return None
    return launches / p["units"]
