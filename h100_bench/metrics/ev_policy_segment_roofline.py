"""ev_policy_segment_roofline: the EV policy-in-kernel rollout's share of
its roofline: the least time its work needs on the card (lib/work.py:
the actor's bf16 products and the projection mat-vecs that the reference
needed on the same inputs, against the bytes read once and written once;
operations bind) over its device time (CUDA events around the kernel's C
entry point, in set-up's second and later train steps, which the
reference follows on the same inputs)."""
from h100_bench.lib import work


def read(ctx):
    ms = ctx.get("kernel_ms", {}).get("ev_policy_segment")
    ex = ctx["extras"]
    if not ms or len(ex.get("matvecs", [])) < len(ms) + 1:
        return None
    mix = ctx["mix"]
    least = 0.0
    for matvecs in ex["matvecs"][1:1 + len(ms)]:
        w = work.ev_policy_segment_work(
            mix["num_envs"], mix["rollout_len"], ex["n"], ex["m2"],
            ex["n_days"], ex["obs_dim"], ctx["config"]["policy"]["hidden"],
            matvecs)
        least += work.bound_s(w["bytes"], w["f32_ops"], w["bf16_ops"])[0]
    return 100.0 * least / (sum(ms) * 1e-3)
