"""market.solve_ms: the SCED solves' device time an episode: the
``pdhg_paired_kernel`` intervals in the profiler's trace of the traced
episodes (the graph replays' kernels), summed, over the episodes. None
where the trace holds fewer launches than one a step."""


def read(ctx):
    solve, mix = ctx.get("solve"), ctx.get("mix")
    if not solve or not mix or solve["launches"] < (
            mix["episode_steps"] * solve["episodes"]) or solve["ms"] <= 0:
        return None
    return solve["ms"] / solve["episodes"]
