#!/usr/bin/env python3
"""Times trainer lines of the port's bench for an A/B against another
checkout on one CUDA card.

    python3 tools/trainer_times.py [--root CHECKOUT] --trainer LABEL ...

Imports ``sustaingym_tpu_torch`` from ``CHECKOUT`` (default: this
repository) and prints, for each ``--trainer`` label of that checkout's
``bench.TRAINERS``, the JSON line of its ``bench_train`` (best of
``bench.REPEATS`` synchronised train steps after a warm-up step that holds
the CUDA-graph captures), with the checkout's path. To compare two
checkouts, unpack the other one with ``git archive`` into a git-ignored
directory and run both in one call, A B B A.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--trainer", action="append", required=True)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from sustaingym_tpu_torch import bench
    if not bench.__file__.startswith(root):
        raise SystemExit(f"imported {bench.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("trainer_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tables = tempfile.mkdtemp(prefix="trainer_times_tables_")
    try:
        for label in args.trainer:
            line = bench.bench_train(label, torch.device("cuda"), tables)
            line.update(label=label, root=root,
                        step_ms=line["batch"] * line["rollout_len"]
                        * line.get("n_agents", 1) / line["value"] * 1e3)
            print(json.dumps(line), flush=True)
            bench.free()
    finally:
        shutil.rmtree(tables)


if __name__ == "__main__":
    main()
