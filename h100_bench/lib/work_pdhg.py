"""The operations and bytes of the market's SCED solves, for the solve
kernel's roofline (``metrics/pdhg_solve_roofline.py``); the peaks are
``lib/work.py``'s. Counted from the LP's shapes and the reference's
iteration budgets, never from the program's counters."""
from __future__ import annotations

from h100_bench.lib import work


def pdhg_solve_work(batch: int, n: int, me: int, ms: int,
                    iters: int) -> dict:
    """One solve of ``batch`` LPs (``n`` variables, ``me`` equality rows,
    ``ms`` paired rows) by ``iters`` PDHG iterations: each iteration's
    two products, K' w for the gradient and K xb for the duals, with K =
    [A; S] (me + ms, n), 2 n (me + ms) FLOPs each in bf16 a env; bytes:
    the problem (c, x0, ub, b, y0, hp, hm, zp0, zm0) read once and the
    solution (x, y, zp, zm) written once, float32."""
    return {"bf16_ops": 4.0 * n * (me + ms) * iters * batch,
            "bytes": 4.0 * (4 * n + 3 * me + 6 * ms) * batch}


def episode_least_s(batch: int, n: int, me: int, ms: int,
                    solve_iters: list) -> float:
    """The least seconds of an episode's solves on the card: each solve's
    bound (``work.bound_s``), summed."""
    total = 0.0
    for iters in solve_iters:
        w = pdhg_solve_work(batch, n, me, ms, iters)
        total += work.bound_s(w["bytes"], bf16_ops=w["bf16_ops"])[0]
    return total
