"""The readings that each limit of ``limits/<workload>.json`` is set from,
on the card at the cell's own size, in one process:

- the program's numbers on each of ``--seeds`` (set-up, a short window,
  from which a driver that samples its answers draws them, the
  comparison);
- on ``--stand-in-seeds``, the same numbers with the reference standing
  in the program's place, computed at the control's lower precision (the
  configuration's ``controls``) and with each fault the cell can have
  planted in it.

    python3 h100_bench/calibrate.py --workload ev-sim --seeds 1 2 3 \\
        --stand-in-seeds 1 2 3 --out chiprun_out/calib_ev-sim.jsonl

``--stand-ins half_batch`` reads one fault alone (``control`` the
control).

Prints one JSON line a seed (and appends it to ``--out``). The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--stand-in-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--stand-ins", nargs="*", default=None,
                        help="which stand-ins to read on --stand-in-seeds: "
                        "'control' and the driver's faults (default all)")
    parser.add_argument("--seconds", type=float, default=2.0,
                        help="seconds of the window before the comparison")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from h100_bench.lib import spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bench = spec.benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    drv_mod = spec.module("traffic", mix["driver"])
    ref_mod = spec.module("reference", config["reference"])
    for seed in dict.fromkeys(args.seeds + args.stand_in_seeds):
        t0 = time.perf_counter()
        driver = drv_mod.Driver(config, mix, seed, dev)
        driver.setup(False)
        driver.window(args.seconds)
        driver.release()
        gc.collect()
        torch.cuda.empty_cache()
        numbers, _ = driver.check(ref_mod)
        row = {"workload": args.workload, "seed": seed}
        if seed in args.seeds:
            row["program"] = numbers
            if hasattr(driver, "diagnostics"):
                row["diagnostics"] = driver.diagnostics()
        if seed in args.stand_in_seeds:
            wanted = args.stand_ins or ("control",) + drv_mod.STAND_IN_FAULTS
            if "control" in wanted:
                row["control"] = driver.stand_in(
                    prec=config["controls"][mix["driver"]])
                if hasattr(driver, "diagnostics"):
                    row["control_diagnostics"] = driver.diagnostics(
                        driver.last_stand_in)
            row["faults"], row["fault_diagnostics"] = {}, {}
            for f in drv_mod.STAND_IN_FAULTS:
                if f not in wanted:
                    continue
                row["faults"][f] = driver.stand_in(fault=f)
                if hasattr(driver, "diagnostics"):
                    row["fault_diagnostics"][f] = driver.diagnostics(
                        driver.last_stand_in)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
