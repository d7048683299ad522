"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 h100_bench/run.py --workload ev-ppo-train --seed 7 \
        --seconds 50 --trace 0

Reads the cell from ``BENCHMARK.json`` at the root of the checkout, runs
it on one CUDA card and prints the result as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit (also the last lines of standard error).
Exits 2 without a card, and 1 without a result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("USE_FLAX", "0")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import json

    import torch

    from h100_bench.lib import cell, spec
    bench = spec.benchmark(ROOT)
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = cell.run_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda"), T_START,
                         log=log)
    if line is None:
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
