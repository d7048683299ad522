#!/usr/bin/env python3
"""Splits the PPO update's device time by kind on one CUDA card, for the
trainers of ``chip_smoke.UPDATE_SPLIT`` (EV and the fused building one).

    python3 tools/update_split.py [--eager]

Builds each trainer of the bench's ``TRAINERS`` at its bench size
(captured, or eager with ``--eager``), runs one train step, then prints
``chip_smoke.update_split``: one traced run of the step's minibatch
updates (``torch.profiler``) split into GEMMs, dtype casts, other copies,
the foreach Adam and gradient clip, and the loss, with each kind's top
kernels. The same split that ``chip_smoke.py --profile`` prints, without
the rest of that run.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--eager", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("update_split: no CUDA device")
    import chip_smoke as cs
    from sustaingym_tpu_torch import bench
    from sustaingym_tpu_torch.parallel import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tag = f"[{cs.card_line()}]"
    kind = "eager" if args.eager else "captured"
    tables = tempfile.mkdtemp(prefix="update_split_tables_")
    try:
        for label in cs.UPDATE_SPLIT:
            _, name, make_kwargs, _ = bench.TRAINERS[label]
            env, p = bench.make_env(name, dev, tables, **make_kwargs)
            cfg = bench.train_config(label)
            init_state, step = make_train_step(env, p, cfg,
                                               capture=not args.eager)
            gen = torch.Generator(device=dev).manual_seed(0)
            carry = init_state(gen)
            step(carry, gen)
            cs.update_split(f"{label} {kind}", step, carry, gen, cfg, tag)
            del init_state, step, carry
            bench.free()
    finally:
        shutil.rmtree(tables)


if __name__ == "__main__":
    main()
