#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — PPO training on EVChargingEnv with the action
projection on — through its public entry points, after checking each
hand-written kernel against its plain PyTorch version on the card:

1. card: name and power limit (``nvidia-smi``), ``torch.cuda`` device;
2. build: compiles ``sustaingym_tpu_torch/ops/cuda/csrc/ev_rollout.cu``;
3. kernel vs plain version, both sites with projection on and caltech with
   projection off, B = 1024 x 288 steps: ``ev_segment`` on prescribed
   actions, ``ev_policy_segment`` on prescribed noise at H = 256; then at
   the main path's shapes, caltech with projection on: ``ev_segment`` at
   32768 x 288 in RNG mode, the plain version replaying the kernel's
   recorded actions, and ``ev_policy_segment`` at 8192 x 288, H = 256, on
   prescribed noise;
4. in-kernel draws: U[0, 1) action mean (the 32768 x 288 run's draws),
   N(0, 1) mean and variance;
5. simulation tier: ``EVChargingEnv.fused_rollout`` at 32768 x 288,
   projection on, kernel and plain version timed with CUDA events;
6. trainer: two PPO train steps at 8192 envs x 288 steps, H = 256, bf16
   obs, 96 minibatches, 4 epochs; then the lr=0 exact-ratio check.

``python3 chip_smoke.py --profile`` adds a phase after 6: the train step's
phases (rollout, re-scoring + GAE, minibatch updates) on the host clock
with ``torch.cuda.synchronize()`` between them, and the device's busy time
over one whole train step from ``torch.profiler``.

Every phase raises on failure (exit code 1). The line before the last is
a JSON object with each kernel's launches in the main-path run (phases 5
and 6), its largest reward difference from the plain version over every
comparison of phase 3, and the kernel's and plain version's times; the
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits
non-zero without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SIM_BATCH, TRAIN_ENVS, STEPS, HIDDEN = 32768, 8192, 288, 256
CHECK_BATCH = 1024


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def q(x, p):
    return float(np.quantile(x.detach().float().cpu().numpy(), p))


FIELDS = ("reward", "profit", "carbon_cost", "excess_charge")


def check_segment(case: str, ko, ro, tag: str) -> float:
    """``ev_segment`` against its plain version: per-field differences,
    rewards rtol 2e-4 / atol 2e-5 over the first 12 steps, q99 and mean of
    |d reward| < 1e-4 over the segment. Returns max |d reward|."""
    import torch
    d = (ko - ro).abs()
    for i, field in enumerate(FIELDS):
        print(f"ev_segment {case} {field}: max|d| {d[..., i].max():.3e} "
              f"q99 {q(d[..., i], 0.99):.3e} {tag}", flush=True)
    torch.testing.assert_close(ko[:12, :, 0], ro[:12, :, 0], rtol=2e-4,
                               atol=2e-5)
    if not (q(d[..., 0], 0.99) < 1e-4 and float(d[..., 0].mean()) < 1e-4):
        fail(f"ev_segment {case}: reward q99/mean out of bounds")
    return float(d[..., 0].max())


def check_policy(case: str, n: int, D: int, kernel, plain, tag: str
                 ) -> float:
    """``ev_policy_segment`` against its plain version with the bounds of
    ``tests/test_ops_pallas.py:355-373``: rewards as ``check_segment``;
    est-departure, timestep and MOER obs equal after bf16; under 1% of
    demand obs off by more than 1e-3; q99 |d u| < 0.02. Returns max
    |d reward|."""
    import torch
    (ko, kl), (ro, rl) = kernel, plain
    kl, rl = kl.float(), rl.float()
    dr = (ko[..., 0] - ro[..., 0]).abs()
    dd = (kl[..., 1 + n:1 + 2 * n] - rl[..., 1 + n:1 + 2 * n]).abs()
    du = (kl[..., D:] - rl[..., D:]).abs()
    est_equal = torch.equal(kl[..., 1:1 + n], rl[..., 1:1 + n])
    aux = [0] + list(range(1 + 2 * n, D))
    aux_equal = torch.equal(kl[..., aux], rl[..., aux])
    share = float((dd > 1e-3).float().mean())
    du_q99 = q(du, 0.99)
    print(f"ev_policy_segment {case}: reward max|d| {dr.max():.3e} "
          f"q99 {q(dr, 0.99):.3e} mean {dr.mean():.3e}; u q99 "
          f"{du_q99:.3e}; demand obs share>1e-3 {share:.2e}; est obs "
          f"equal {est_equal}; timestep/moer obs equal {aux_equal} {tag}",
          flush=True)
    torch.testing.assert_close(ko[:12, :, 0], ro[:12, :, 0], rtol=2e-4,
                               atol=2e-5)
    if not (est_equal and aux_equal and share < 0.01 and du_q99 < 0.02
            and q(dr, 0.99) < 1e-4 and float(dr.mean()) < 1e-4):
        fail(f"ev_policy_segment {case}: outside the policy-block bounds")
    return float(dr.max())


def profile_train_step(train_step, carry, generator, cfg, tag: str):
    """Phase times of the train step (host clock, synchronised between
    phases) and the device's busy time over one whole step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    policy, opt = carry["policy"], carry["opt"]
    updates = cfg.epochs * cfg.minibatches
    for i in range(2):
        out, roll_ms = timed(lambda: train_step.rollout(policy, generator))
        flat, score_ms = timed(lambda: train_step.score(policy, out))
        _, upd_ms = timed(lambda: train_step.update(policy, opt, flat,
                                                    generator))
        _, step_ms = timed(lambda: train_step(carry, generator))
        print(f"profile {i}: train step {step_ms:.1f} ms; rollout "
              f"{roll_ms:.1f} ms, re-scoring + GAE {score_ms:.1f} ms, "
              f"{updates} minibatch updates {upd_ms:.1f} ms = "
              f"{upd_ms / updates:.3f} ms each {tag}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced_ms = timed(lambda: train_step(carry, generator))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernels and copies only: CPU ops carry their kernels'
    # time as well, and device-side user annotations (Optimizer.step) span
    # kernels that are counted on their own
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print(f"profile: the trace holds no device time (not measured) "
              f"{tag}")
        return
    print(f"profile: traced train step {traced_ms:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / step_ms:.1%} of the untraced "
          f"step {step_ms:.1f} ms {tag}")
    for e in events[:10]:
        print(f"  {dev_us(e) / 1e3:9.1f} ms device  {e.count:6d} calls  "
              f"{e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    want_profile = "--profile" in sys.argv[1:]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.ops.cuda import build
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    from sustaingym_tpu_torch.parallel import (PPOConfig, init_policy,
                                               make_train_step)

    # plain versions are the oracle: full-f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card --------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(f"card: {card}; torch.cuda device: {kind}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("ev_rollout", verbose=True)
    print(f"build: ev_rollout.cu in {time.perf_counter() - t0:.3f} s {tag}",
          flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"ev_segment": 0.0, "ev_policy_segment": 0.0}

    # ---- 3. kernel vs plain version ---------------------------------------
    B, T = CHECK_BATCH, STEPS
    for site, proj in (("caltech", True), ("jpl", True), ("caltech", False)):
        env, p = make("evcharging", site=site, project_action=proj,
                      device=dev)
        n, k = p.n_stations, p.moer_forecast_steps
        D = 2 + 2 * n + k
        days = torch.randint(p.n_days, (B,), generator=gen, device=dev)
        case = f"{site} projection={'on' if proj else 'off'} {B}x{T}"

        acts = torch.rand((T, B, n), generator=gen, device=dev)
        e = check_segment(case, K.ev_segment(p, days, T, actions=acts)[0],
                          K.ev_segment_ref(p, days, T, actions=acts)[0], tag)
        err["ev_segment"] = max(err["ev_segment"], e)

        pol = init_policy(D, n, HIDDEN, torch.Generator().manual_seed(1), dev)
        w = K.pack_policy_weights(pol)
        noise = torch.randn((T, B, n), generator=gen, device=dev)
        e = check_policy(case, n, D,
                         K.ev_policy_segment(p, w, days, T, noise=noise),
                         K.ev_policy_segment_ref(p, w, days, T, noise=noise),
                         tag)
        err["ev_policy_segment"] = max(err["ev_policy_segment"], e)

    # the main path's shapes: caltech, projection on
    env, p = make("evcharging", device=dev)
    n, k = p.n_stations, p.moer_forecast_steps
    D = 2 + 2 * n + k
    days = torch.randint(p.n_days, (SIM_BATCH,), generator=gen, device=dev)
    ko, acts = K.ev_segment(p, days, STEPS, seed=7, record_actions=True)
    ro, _ = K.ev_segment_ref(p, days, STEPS, actions=acts)
    e = check_segment(f"caltech projection=on {SIM_BATCH}x{STEPS} in-kernel "
                      f"draws", ko, ro, tag)
    err["ev_segment"] = max(err["ev_segment"], e)

    # ---- 4. in-kernel draws ----------------------------------------------
    a_mean = float(acts.mean())
    print(f"uniform draws: {acts.numel()} mean {a_mean:.6f} var "
          f"{float(acts.var()):.6f} min {float(acts.min()):.3e} max "
          f"{float(acts.max()):.6f} {tag}", flush=True)
    if not (abs(a_mean - 0.5) < 0.005 and float(acts.min()) >= 0.0
            and float(acts.max()) < 1.0):
        fail("uniform action draws off")
    del ko, ro, acts

    w = K.pack_policy_weights(init_policy(
        D, n, HIDDEN, torch.Generator().manual_seed(2), dev))
    days = torch.randint(p.n_days, (TRAIN_ENVS,), generator=gen, device=dev)
    noise = torch.randn((STEPS, TRAIN_ENVS, n), generator=gen, device=dev)
    e = check_policy(f"caltech projection=on {TRAIN_ENVS}x{STEPS} H={HIDDEN}",
                     n, D, K.ev_policy_segment(p, w, days, STEPS, noise=noise),
                     K.ev_policy_segment_ref(p, w, days, STEPS, noise=noise),
                     tag)
    err["ev_policy_segment"] = max(err["ev_policy_segment"], e)
    del noise
    pol_ms = cuda_ms(lambda: K.ev_policy_segment(p, w, days, STEPS, seed=3),
                     3)
    pol_plain_ms = cuda_ms(lambda: K.ev_policy_segment_ref(
        p, w, days, STEPS, seed=3), 1)
    print(f"ev_policy_segment {TRAIN_ENVS}x{STEPS} H={HIDDEN}: kernel "
          f"{pol_ms:.3f} ms, plain {pol_plain_ms:.3f} ms {tag}", flush=True)

    days = torch.randint(p.n_days, (B,), generator=gen, device=dev)
    zero = init_policy(D, n, HIDDEN, torch.Generator().manual_seed(4), dev)
    with torch.no_grad():
        zero.mu.weight.zero_()
        zero.log_std.zero_()
    _, lrn = K.ev_policy_segment(p, K.pack_policy_weights(zero), days, T,
                                 seed=8)
    z = lrn[..., D:].float()                     # u = 0 + 1 * N(0, 1), bf16
    z_mean, z_var = float(z.mean()), float(z.var())
    print(f"normal draws: {z.numel()} mean {z_mean:.6f} var {z_var:.6f} "
          f"{tag}")
    if not (abs(z_mean) < 0.01 and abs(z_var - 1.0) < 0.01):
        fail("normal draws off")

    # ---- main path: counts from 0 -----------------------------------------
    K.ev_segment.launches = 0
    K.ev_policy_segment.launches = 0

    # ---- 5. simulation tier -----------------------------------------------
    sim_gen = torch.Generator(device=dev).manual_seed(11)
    roll = env.fused_rollout(p, SIM_BATCH, STEPS, generator=sim_gen)
    if roll.reward.shape != (STEPS, SIM_BATCH) \
            or not bool(torch.isfinite(roll.reward).all()):
        fail("simulation tier: bad rewards")
    seg_ms = cuda_ms(lambda: env.fused_rollout(p, SIM_BATCH, STEPS,
                                               generator=sim_gen), 3)
    days = torch.randint(p.n_days, (SIM_BATCH,), generator=gen, device=dev)
    seg_plain_ms = cuda_ms(lambda: K.ev_segment_ref(p, days, STEPS,
                                                    seed=12), 1)
    steps = SIM_BATCH * STEPS
    print(f"simulation tier {SIM_BATCH}x{STEPS} projection on: kernel "
          f"{seg_ms:.3f} ms = {steps / seg_ms * 1e3:.0f} env-steps/s; plain "
          f"{seg_plain_ms:.3f} ms = {steps / seg_plain_ms * 1e3:.0f} "
          f"env-steps/s; mean reward {float(roll.reward.mean()):.6f} {tag}",
          flush=True)

    # ---- 6. trainer --------------------------------------------------------
    cfg = PPOConfig(num_envs=TRAIN_ENVS, hidden=HIDDEN, minibatches=96,
                    epochs=4)
    init_state, train_step = make_train_step(env, p, cfg)
    tgen = torch.Generator(device=dev).manual_seed(21)
    carry = init_state(tgen)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, tgen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        m = {key: float(v) for key, v in metrics.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"train step {i}: non-finite metrics {m}")
        print(f"train step {i}: {dt:.3f} s = "
              f"{TRAIN_ENVS * STEPS / dt:.0f} env-steps/s; "
              f"{json.dumps(m)} {tag}", flush=True)
    cfg0 = PPOConfig(num_envs=CHECK_BATCH, hidden=HIDDEN, minibatches=4,
                     epochs=1, lr=0.0)
    init0, step0 = make_train_step(env, p, cfg0)
    _, m0 = step0(init0(tgen), tgen)
    pg0 = float(m0["pg_loss"])
    print(f"lr=0 train step at {CHECK_BATCH} envs: pg_loss {pg0:.3e} {tag}")
    if not abs(pg0) < 1e-5:
        fail(f"lr=0 exact-ratio invariant broken: pg_loss {pg0}")

    launches = {"ev_segment": K.ev_segment.launches,
                "ev_policy_segment": K.ev_policy_segment.launches}
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if want_profile:
        profile_train_step(train_step, carry, tgen, cfg, tag)

    src = "sustaingym_tpu_torch/ops/cuda/csrc/ev_rollout.cu"
    kernels = [
        {"name": "ev_segment", "route": "cuda", "source": src,
         "replaces": "sustaingym_tpu/ops/pallas/ev_rollout.py:337",
         "launches": launches["ev_segment"],
         "max_abs_err": err["ev_segment"], "ms": seg_ms,
         "plain_ms": seg_plain_ms},
        {"name": "ev_policy_segment", "route": "cuda", "source": src,
         "replaces": "sustaingym_tpu/ops/pallas/ev_rollout.py:674",
         "launches": launches["ev_policy_segment"],
         "max_abs_err": err["ev_policy_segment"], "ms": pol_ms,
         "plain_ms": pol_plain_ms},
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
