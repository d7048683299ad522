"""learner.fused_loss_launches_per_step: the fused PPO loss head's calls a
train step, the launches that the program's ``ppo_gauss_loss`` wrapper
(``ops/cuda/ppo_loss.py``) counted over the steps of its traced pass
(``lib/program.py``, tracing alone), replays of captured minibatches
included. None where the program has no such wrapper."""
from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    launches = p["light"].get("launches", {}).get("ppo_gauss_loss")
    if launches is None:
        return None
    return launches / p["units"]
