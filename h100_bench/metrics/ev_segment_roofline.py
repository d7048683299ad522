"""ev_segment_roofline: the EV simulation kernel's share of its roofline
over the traced episodes the comparison checked: the least time their
work needs on the card (lib/work.py: the projection and reward mat-vecs
that the reference needed on the same days and draws, stopping each
step's FISTA where the reference reaches its fixed point, against the
bytes read once and written once) over their device time (CUDA events
around the kernel's C entry point)."""
from h100_bench.lib import work


def read(ctx):
    ms = ctx.get("kernel_ms", {}).get("ev_segment")
    ex = ctx["extras"]
    if not ms or not ex.get("matvecs"):
        return None
    mix = ctx["mix"]
    least = spent = 0.0
    for i, matvecs in ex["matvecs"].items():
        w = work.ev_segment_work(mix["batch"], mix["episode_steps"], ex["n"],
                                 ex["m2"], ex["n_days"], matvecs)
        least += work.bound_s(w["bytes"], w["f32_ops"])[0]
        spent += ms[i] * 1e-3
    return 100.0 * least / spent
