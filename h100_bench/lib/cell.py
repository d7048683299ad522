"""One run of one cell: set-up, the measured (or traced) window, the
checks that nothing of JAX was loaded, the comparison with the plain
reference, and the result line."""
from __future__ import annotations

import gc
import subprocess
import sys
import time

from h100_bench.lib import compare, spec

# top-level module names the run must not have loaded (the JAX package's
# name is compared whole, so its port's name passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "sustaingym_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card(device) -> dict:
    """The device block of the result line (peak memory added later)."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout else "not read"


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: dict | None = None,
             faults=(), log=print) -> dict | None:
    """Runs cell ``name`` once; returns the result line, or None where the
    run had loaded JAX or the JAX package by the time the line was made
    (the comparison and the metrics' readers included). ``overrides``
    change the traffic mix's parameters (the CPU tests' small sizes);
    ``faults`` break the program underneath (the tests that the
    comparison catches each). ``log`` prints to standard error."""
    import torch
    cell = spec.workload(bench, name)
    config = spec.config(cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), **(overrides or {}))
    limits = spec.limits(name)
    driver = spec.module("traffic", mix["driver"]).Driver(
        config, mix, seed, device, faults)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver.setup(trace)
    setup_s = time.perf_counter() - t_start
    got = driver.traced(seconds) if trace else driver.window(seconds)
    dev = card(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    else:
        dev["memory_peak_bytes"] = 0
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, extras = driver.check(spec.module("reference",
                                               config["reference"]))
    log(f"comparison: {time.perf_counter() - t_check:.1f} s")
    correct = compare.judge(numbers, limits)
    metrics = {}
    if trace:
        ctx = dict(got, extras=extras, config=config, mix=mix, cell=cell)
        for m in spec.per_layer(bench, name):
            value = spec.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = got["trace"]["busy_s"]
        dev["window_s"] = got["trace"]["window_s"]
    else:
        values = dict(got["metrics"], setup_s=setup_s,
                      peak_mem_gib=dev["memory_peak_bytes"] / 2 ** 30)
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        for key, count in got.get("samples", {}).items():
            log(f"{key}: {count} samples")
        if got.get("step_s"):
            times = sorted(got["step_s"])
            log(f"window: {len(times)} steps, seconds a step min "
                f"{times[0]:.4f} median {times[len(times) // 2]:.4f} max "
                f"{times[-1]:.4f}")
            slow = [i for i, t in enumerate(got["step_s"])
                    if t > 1.03 * times[0]]
            log(f"steps over 1.03 x the fastest: {len(slow)} of "
                f"{len(times)}" + (f", the first at step {slow[0]}, the "
                                   f"last at step {slow[-1]}" if slow else ""))
    over = sum(1 for k, v in numbers.items() if not v <= limits[k])
    line = {"correct": correct, "attempted": got["attempted"],
            "failed": over, "metrics": metrics,
            "device": dev}
    if trace:
        line["breakdown"] = {k: got["trace"][k] for k in
                             ("device_ops", "idle_gaps")}
    line["checks"] = {k: {"value": v, "limit": limits[k]}
                      for k, v in numbers.items()}
    log(f"setup_s: {setup_s:.3f}; card: {power_limit()}")
    for k, v in numbers.items():
        log(f"{k}: {v!r} (limit {limits[k]!r})")
    loaded = forbidden_modules()
    if loaded:
        log(f"the run loaded {', '.join(loaded)}; no result")
        return None
    return line
