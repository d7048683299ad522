"""device.idle_pct.market: the share of the traced window in which no
kernel ran on the card: 100 minus the union of the device's kernel
intervals (overlaps counted once) over the window, from the profiler's
trace of that window."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
