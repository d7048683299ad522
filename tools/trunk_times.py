#!/usr/bin/env python3
"""Times the PPO trunk's glue passes (``ops/cuda/ppo_trunk.py``) on one
CUDA card at the EV trainer's shapes, beside their byte bounds and plain
versions.

    python3 tools/trunk_times.py

At a minibatch (24576 rows, hidden 256, the 146-wide obs), as
``chip_smoke.py`` times them for its ``kernels`` line
(``chip_smoke.trunk_times``): the forward pass with and without the kept
``y``, the backward pass without and with the obs copy (the second and
the first layer's), each by CUDA events around its C entry point, with
the least time of its bytes at 3.35 TB/s and the plain version's time;
then the forward pass without ``y`` at the scoring's 2,359,296 rows.
Prints one JSON line with the card's name and power limit. (The passes'
share of a captured update: ``tools/update_split.py``.)
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("trunk_times: no CUDA device")
    import chip_smoke as cs
    from sustaingym_tpu_torch.ops.cuda import build
    from sustaingym_tpu_torch.ops.cuda import ppo_trunk as K
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.load_libraries(["ppo_trunk"], verbose=True)
    rows, H, D, score_rows = 24576, 256, 146, 2359296
    g = torch.Generator(device=dev).manual_seed(0)
    args = cs.trunk_inputs(rows, H, D, g)
    out = {"card": cs.card_line(), "rows": rows, "hidden": H,
           **cs.trunk_times(args)}
    bias = args[1]
    del args
    big = torch.randn((score_rows, H), generator=g, device=dev)
    out["score_forward"] = {
        "rows": score_rows,
        "ms": cs.device_ms(lambda: K.trunk_forward(big, bias, False),
                           "ppo_trunk_forward_launch", 10),
        "bound_ms": cs.bound(score_rows * H * 6)[0]}
    del big
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
