#!/usr/bin/env python3
"""Times the PyTorch port's policy and PDHG kernels on one CUDA card.

    python3 tools/kernel_times.py [--root CHECKOUT]

Imports ``sustaingym_tpu_torch`` and ``chip_smoke`` from ``CHECKOUT``
(default: this repository), builds its kernels (printing the compiler's
registers and spills), and times, by CUDA events over back-to-back calls
after a warm-up call, at the main paths' shapes:

- ``ev_policy_segment`` at 8192 x 288, H = 256, caltech, with the action
  projection on and off (the env step's projection and the rest of the
  kernel, apart);
- ``building_policy_segment`` at 8192 x 288, H = 256, on the 6-zone office
  of ``chip_smoke.write_building_tables``;
- ``pdhg_solve_paired`` at B = 4096 on the market's own problems (reset
  envs, bids uniform over the action box): one warm (40 iterations) and one
  cold (200) solve.

Prints one JSON line with the times in ms, the card's name and power
limit and the checkout. To compare two checkouts on one card, run this on
each in turns (A B B A) on one machine.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

TRAIN_ENVS, STEPS, HIDDEN, MKT_BATCH = 8192, 288, 256, 4096


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.envs import building
    from sustaingym_tpu_torch.envs.electricitymarket.env import MAX_BID
    from sustaingym_tpu_torch.ops.cuda import build
    from sustaingym_tpu_torch.ops.cuda import building_rollout as K5
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    from sustaingym_tpu_torch.ops.cuda import lp_solve as K9
    from sustaingym_tpu_torch.parallel import init_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_libraries(("ev_rollout", "lp_solve", "building_rollout"),
                         verbose=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": root, "card": cs.card_line()}

    for proj in (True, False):
        _, p = make("evcharging", project_action=proj, device=dev)
        n, k = p.n_stations, p.moer_forecast_steps
        w = K.pack_policy_weights(init_policy(
            2 + 2 * n + k, n, HIDDEN, torch.Generator().manual_seed(2), dev))
        days = torch.randint(p.n_days, (TRAIN_ENVS,), generator=gen,
                             device=dev)
        out[f"ev_policy_segment projection {'on' if proj else 'off'}"] = \
            cs.cuda_ms(lambda: K.ev_policy_segment(p, w, days, STEPS, seed=3),
                       3)

    tables = tempfile.mkdtemp(prefix="building_tables_")
    try:
        htm, epw = cs.write_building_tables(tables)
        _, p = building.make_env(htm, epw, "Tucson", device=dev, root=tables,
                                 u_wall=building.BUILDINGS["OfficeSmall"][1])
    finally:
        shutil.rmtree(tables)
    w = K.pack_policy_weights(init_policy(
        p.n + 4, p.n, HIDDEN, torch.Generator().manual_seed(68), dev))
    epochs = torch.randint(p.length_of_weather - 1, (TRAIN_ENVS,),
                           generator=gen, device=dev)
    out["building_policy_segment"] = cs.cuda_ms(
        lambda: K5.building_policy_segment(p, w, epochs, STEPS, seed=69), 3)

    env, p = make("electricitymarket", device=dev)
    op, ms = p.op, p.op.ms
    kops = K9.pack_pdhg_operands(op)
    state, _ = env.reset(p, gen, MKT_BATCH)
    bids = torch.rand((MKT_BATCH, 2 * p.horizon), generator=gen,
                      device=dev) * MAX_BID
    c, b, hh, init, _ = env._sced_problem(p, state, bids)
    market = (c, b, hh[:, :ms].contiguous(), hh[:, ms:].contiguous(), p.ub,
              init.x, init.y, init.z[:, :ms].contiguous(),
              init.z[:, ms:].contiguous())
    for label, iters, reps in (("warm", p.lp_warm_iters, 10),
                               ("cold", op.iters, 3)):
        out[f"pdhg_solve_paired {label} ({iters} iterations)"] = cs.cuda_ms(
            lambda: K9.pdhg_solve_paired(kops, *market, iters), reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
