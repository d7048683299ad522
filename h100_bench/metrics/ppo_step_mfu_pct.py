"""ppo_step_mfu_pct: the whole PPO train step's share of the card's bf16
dense peak (989 TFLOP/s, the highest peak of the precisions the step
uses): the actor-critic MLP's FLOPs (the rollout's forward, the scoring
forward, each epoch's forward and backward over all rows; lib/work.py)
over the traced steps' mean wall time (the three phases' spans)."""
from h100_bench.lib import work


def read(ctx):
    spans = ctx.get("spans")
    if not spans or not spans.get("update"):
        return None
    step_s = sum(sum(v) / len(v) for v in spans.values())
    mix, ex = ctx["mix"], ctx["extras"]
    flops = work.ppo_step_flops(mix["num_envs"] * mix["rollout_len"],
                                mix["epochs"], ex["obs_dim"],
                                ctx["config"]["policy"]["hidden"], ex["n"])
    return 100.0 * flops / step_s / work.PEAK_BF16
