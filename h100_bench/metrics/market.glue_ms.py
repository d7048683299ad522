"""market.glue_ms: the episode's device busy time outside the SCED solves
(the SCED's assembly, the clearing, the obs, the bids, the eager starts):
the union of kernel intervals over the traced window less the
``pdhg_paired_kernel`` time, over the episodes, from the profiler's
trace. None where the trace holds fewer solve launches than one a
step."""


def read(ctx):
    solve, tr, mix = ctx.get("solve"), ctx.get("trace"), ctx.get("mix")
    if not solve or not tr or not mix or solve["launches"] < (
            mix["episode_steps"] * solve["episodes"]) or solve["ms"] <= 0:
        return None
    return (tr["busy_s"] * 1e3 - solve["ms"]) / solve["episodes"]
