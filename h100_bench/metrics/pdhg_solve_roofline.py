"""pdhg_solve_roofline: the market's SCED solve kernel's share of its
roofline: the least time of the solves the reference ran (lib/
work_pdhg.py: each iteration's two bf16 products at the bf16 peak, the
problem read and the solution written once; operations bind) over the
kernel's device time in the traced episodes (``pdhg_paired_kernel`` in
the profiler's trace of the graph replays). None where the trace holds
fewer launches than the episodes' solves (it lost some)."""
from h100_bench.lib import work_pdhg


def read(ctx):
    solve, ex = ctx.get("solve"), ctx["extras"]
    if not solve or not ex.get("solve_iters") or solve["ms"] <= 0:
        return None
    iters = ex["solve_iters"]
    if solve["launches"] < len(iters) * solve["episodes"]:
        return None
    least = work_pdhg.episode_least_s(ex["batch"], ex["n"], ex["me"],
                                      ex["ms"], iters)
    return 100.0 * least * solve["episodes"] / (solve["ms"] * 1e-3)
