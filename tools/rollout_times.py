#!/usr/bin/env python3
"""Times, on one CUDA card, the trainer phases that this checkout's
generic-rollout reset schedule and bf16 learner GEMMs change, for an A/B
against another checkout.

    python3 tools/rollout_times.py [--root CHECKOUT]

Imports ``sustaingym_tpu_torch`` from ``CHECKOUT`` (default: this
repository) and ``chip_smoke`` from this repository, and times at the
bench's sizes (``bench.TRAINERS`` / ``OFF_POLICY``), by CUDA events:

- the captured rollout phase of the EV generic trainer (8192 x 64) and
  of SAC EV (2048 x 64), nine calls from a fresh carry (the clock from 0
  to 512; two of them cross an episode end): the mean of the calls
  after the first (which holds the captures) without an episode end and
  with one;
- the captured EV and fused building trainers (8192 x 288): their train
  step (three steps, the last two's mean, host clock with a synchronise)
  and their update phase alone (two calls after the step's, on the same
  samples).

Prints one JSON line with the times in ms, the card's name and power
limit and the checkout. To compare two checkouts on one card, run this on
each in turns (A B B A) in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, T = 288, 64


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default=HERE)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rollout_times: no CUDA device")
    import chip_smoke as cs
    from sustaingym_tpu_torch import bench
    from sustaingym_tpu_torch.parallel import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    times = {}
    tables = tempfile.mkdtemp(prefix="rollout_times_tables_")
    try:
        for label in ("EV generic", "SAC EV"):
            gen = torch.Generator(device=dev).manual_seed(0)
            if label == "SAC EV":
                _, _, name, kw, _ = bench.OFF_POLICY[label]
                env, p = bench.make_env(name, dev, tables, **kw)
                _, init_state, step = bench.off_policy_trainer(label, env, p)
                carry = init_state(gen)

                def roll():
                    step.rollout(carry, gen)
            else:
                _, name, kw, _ = bench.TRAINERS[label]
                env, p = bench.make_env(name, dev, tables, **kw)
                init_state, step = make_train_step(
                    env, p, bench.train_config(label))
                carry = init_state(gen)

                def roll():
                    step.rollout(carry["policy"], gen, carry)
            calls = []
            for i in range(9):
                ends = (i * T + T) // STEPS > (i * T) // STEPS
                calls.append((ends, cs.cuda_ms(roll, 1)))
            times[f"{label} rollout"] = float(np.mean(
                [ms for ends, ms in calls[1:] if not ends]))
            times[f"{label} rollout with an episode end"] = float(np.mean(
                [ms for ends, ms in calls[1:] if ends]))
            del init_state, step, carry
            bench.free()
        for label in ("EV", "building fused"):
            _, name, kw, _ = bench.TRAINERS[label]
            env, p = bench.make_env(name, dev, tables, **kw)
            cfg = bench.train_config(label)
            init_state, step = make_train_step(env, p, cfg)
            gen = torch.Generator(device=dev).manual_seed(1)
            carry = init_state(gen)
            dts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry, m = step(carry, gen)
                torch.cuda.synchronize()
                dts.append(1e3 * (time.perf_counter() - t0))
            times[f"{label} train step"] = float(np.mean(dts[1:]))
            policy, opt = carry["policy"], carry["opt"]
            flat = step.score(policy, step.rollout(policy, gen))
            times[f"{label} update"] = cs.cuda_ms(
                lambda: step.update(policy, opt, flat, gen), 2)
            del init_state, step, carry, flat
            bench.free()
    finally:
        shutil.rmtree(tables)
    print(json.dumps({"times_ms": times, "card": cs.card_line(),
                      "checkout": root}), flush=True)


if __name__ == "__main__":
    main()
