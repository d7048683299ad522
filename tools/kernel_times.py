#!/usr/bin/env python3
"""Times the PyTorch port's EV, building-policy and PDHG kernels on one
CUDA card, and keeps their outputs for an A/B against another checkout.

    python3 tools/kernel_times.py [--root CHECKOUT] [--save FILE]
                                  [--compare FILE ...]

Imports ``sustaingym_tpu_torch`` from ``CHECKOUT`` (default: this
repository), and ``chip_smoke`` and the synthetic building
(``sustaingym_tpu_torch/envs/building/synthetic.py``) from this
repository, builds the checkout's
kernels (printing the compiler's registers and spills), and times, by
CUDA events over back-to-back calls after a warm-up call, at the main
paths' shapes:

- ``ev_segment`` at 32768 x 288, caltech, projection on, in-kernel draws
  (seed 12), and the same with 0 FISTA iterations (the projection's
  iterations and the rest of the kernel, apart); then on prescribed
  near-full rates 0.8 + 0.2 U[0, 1), which bind the cones in most steps;
  each with the mat-vecs with C the kernel ran per env step where it
  counts them (the full loop runs 32); then the same three lines with the
  ADMM projection (``proj_method="admm"``, 30 iterations, every one run:
  62 mat-vecs with C an env step, fewer where C' y's y is 0);
- ``ev_policy_segment`` at 8192 x 288, H = 256, caltech, with the action
  projection on and off;
- ``building_policy_segment`` at 8192 x 288, H = 256, on the 6-zone office
  of ``synthetic.write_building_tables``, and at H = 16 (the actor's
  products nearly gone: the env step, draws and barriers);
- ``pdhg_solve_paired`` at B = 4096 on the market's own problems (reset
  envs, bids uniform over the action box): one warm (40 iterations) and one
  cold (200) solve; and ``chip_smoke.pdhg_int_digest``, the SHA-256 of its
  int-budget outputs on ``chip_smoke.py`` phase 35's problems (the value
  of ``chip_smoke.PARENT_PDHG_INT_DIGEST`` when run on the checkout
  before per-env budgets).

Each call (the EV and PDHG ones) goes through its wrapper, whose range
checks wait on the host between launches (~0.1 ms).

Outputs, on inputs that are the same in every run (seeded on the card):
``ev_segment`` of the two timed calls with each operator,
``ev_policy_segment`` and
``building_policy_segment`` on prescribed noise at the timed shapes and
with their in-kernel draws (the SHA-256 of both outputs: the draws'
Philox counters), and the warm and cold PDHG solves. ``--save`` writes them to FILE (the EV
policy kernel's 0.9 GB learner block as its SHA-256); each ``--compare``
loads another run's FILE and prints, per output, bit-equal or max |d|.
The building output also gets ``chip_smoke.policy_drift`` against its
plain version. Prints one JSON line with the times in ms, the card's name
and power limit and the checkout. To compare two checkouts on one card,
run this on each in turns (A B B A) in one call.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import shutil
import sys
import tempfile

TRAIN_ENVS, SIM_ENVS, STEPS, HIDDEN, MKT_BATCH = 8192, 32768, 288, 256, 4096
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def _digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import torch
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()

def _load(name: str, path: str):
    """This repository's module at ``path``, whichever checkout is
    measured."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare(outs: dict, other: dict) -> dict:
    """Per output: "bit-equal", or max |d| (a digest: "differs")."""
    import torch
    res = {}
    for key, x in outs.items():
        y = other.get(key)
        if y is None:
            res[key] = "missing"
        elif isinstance(x, str):
            res[key] = "bit-equal" if x == y else "differs"
        elif torch.equal(x, y):
            res[key] = "bit-equal"
        else:
            res[key] = float((x.double() - y.double()).abs().max())
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--save")
    ap.add_argument("--compare", action="append", default=[])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    cs = _load("chip_smoke", "chip_smoke.py")
    synthetic = _load("synthetic",
                      "sustaingym_tpu_torch/envs/building/synthetic.py")
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.core import replace
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
    times = {"root": root, "card": cs.card_line()}
    outs = {}

    _, p = make("evcharging", device=dev)
    days = torch.randint(p.n_days, (SIM_ENVS,), generator=gen, device=dev)
    acts = 0.8 + 0.2 * torch.rand((STEPS, SIM_ENVS, p.n_stations),
                                  generator=gen, device=dev)
    counts = "matvecs" in inspect.signature(K.ev_segment).parameters

    def matvecs_per_step(params, **kw):
        if counts:
            run = torch.zeros((), dtype=torch.long, device=dev)
            K.ev_segment(params, days, STEPS, matvecs=run, **kw)
            return int(run) / (SIM_ENVS * STEPS)

    for method, label, it_name in (("dual", "ev_segment", "FISTA"),
                                   ("admm", "ev_segment ADMM", "ADMM")):
        _, p = make("evcharging", proj_method=method, device=dev)
        p0 = replace(p, proj=replace(p.proj, iters=0))
        times[label] = cs.cuda_ms(
            lambda: K.ev_segment(p, days, STEPS, seed=12), 3)
        outs[label] = K.ev_segment(p, days, STEPS, seed=12)[0].cpu()
        times[f"{label} mat-vecs per env step"] = matvecs_per_step(p, seed=12)
        times[f"{label} 0 {it_name} iterations"] = cs.cuda_ms(
            lambda: K.ev_segment(p0, days, STEPS, seed=12), 3)
        times[f"{label} 0 {it_name} iterations mat-vecs per env step"] = \
            matvecs_per_step(p0, seed=12)
        times[f"{label} cone-binding actions"] = cs.cuda_ms(
            lambda: K.ev_segment(p, days, STEPS, actions=acts), 3)
        times[f"{label} cone-binding mat-vecs per env step"] = \
            matvecs_per_step(p, actions=acts)
        outs[f"{label} cone-binding"] = K.ev_segment(
            p, days, STEPS, actions=acts)[0].cpu()
    del acts

    for proj in (True, False):
        _, p = make("evcharging", project_action=proj, device=dev)
        n, k = p.n_stations, p.moer_forecast_steps
        w = K.pack_policy_weights(init_policy(
            2 + 2 * n + k, n, HIDDEN, torch.Generator().manual_seed(2), dev))
        days = torch.randint(p.n_days, (TRAIN_ENVS,), generator=gen,
                             device=dev)
        times[f"ev_policy_segment projection {'on' if proj else 'off'}"] = \
            cs.cuda_ms(lambda: K.ev_policy_segment(p, w, days, STEPS, seed=3),
                       3)
        if proj:
            noise = torch.randn((STEPS, TRAIN_ENVS, n), generator=gen,
                                device=dev)
            out, lrn = K.ev_policy_segment(p, w, days, STEPS, noise=noise)
            outs["ev_policy_segment out"] = out.cpu()
            outs["ev_policy_segment learner block"] = hashlib.sha256(
                lrn.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            out, lrn = K.ev_policy_segment(p, w, days, STEPS, seed=3)
            outs["ev_policy_segment in-kernel draws"] = _digest(out, lrn)
            del noise, lrn

    tables = tempfile.mkdtemp(prefix="building_tables_")
    try:
        htm, epw = synthetic.write_building_tables(tables)
        _, p = building.make_env(htm, epw, "Tucson", device=dev, root=tables,
                                 u_wall=building.BUILDINGS["OfficeSmall"][1])
    finally:
        shutil.rmtree(tables)
    w = K.pack_policy_weights(init_policy(
        p.n + 4, p.n, HIDDEN, torch.Generator().manual_seed(68), dev))
    epochs = torch.randint(p.length_of_weather - 1, (TRAIN_ENVS,),
                           generator=gen, device=dev)
    times["building_policy_segment"] = cs.cuda_ms(
        lambda: K5.building_policy_segment(p, w, epochs, STEPS, seed=69), 3)
    w16 = K.pack_policy_weights(init_policy(
        p.n + 4, p.n, 16, torch.Generator().manual_seed(68), dev))
    times["building_policy_segment H=16"] = cs.cuda_ms(
        lambda: K5.building_policy_segment(p, w16, epochs, STEPS, seed=69), 3)
    noise = torch.randn((STEPS, TRAIN_ENVS, p.n), generator=gen, device=dev)
    kernel = K5.building_policy_segment(p, w, epochs, STEPS, noise=noise)
    plain = K5.building_policy_segment_ref(p, w, epochs, STEPS, noise=noise)
    print(f"building_policy_segment {TRAIN_ENVS}x{STEPS} drift: "
          f"{cs.policy_drift(p.n, kernel, plain)} [{root}]", flush=True)
    outs["building_policy_segment out"] = kernel[0].cpu()
    outs["building_policy_segment learner block"] = kernel[1].cpu()
    outs["building_policy_segment in-kernel draws"] = _digest(
        *K5.building_policy_segment(p, w, epochs, STEPS, seed=69))
    del noise, kernel, plain

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
        times[f"pdhg_solve_paired {label} ({iters} iterations)"] = cs.cuda_ms(
            lambda: K9.pdhg_solve_paired(kops, *market, iters), reps)
        for name, x in zip(("x", "y", "zp", "zm"),
                           K9.pdhg_solve_paired(kops, *market, iters)):
            outs[f"pdhg_solve_paired {label} {name}"] = x.cpu()
    times["pdhg_int_digest"] = cs.pdhg_int_digest(env, p, K9)
    print(json.dumps(times), flush=True)
    if args.save:
        torch.save(outs, args.save)
    for path in args.compare:
        print(f"outputs against {path}: "
              f"{json.dumps(compare(outs, torch.load(path)))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
