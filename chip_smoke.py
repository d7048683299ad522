#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two slices through their public entry points, after
checking each hand-written kernel against its plain PyTorch version on the
card. Slice 1, PPO on EVChargingEnv with the action projection on:

1. card: name and power limit (``nvidia-smi``), ``torch.cuda`` device;
2. build: compiles every ``sustaingym_tpu_torch/ops/cuda/csrc/*.cu`` (one
   ``nvcc`` each, all at once), printing registers and spills;
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

Slice 2, CogenEnv:

7. ``episode_slice_gather`` vs its plain version (one advanced-indexing
   call, also timed as the library call), bit-equal: the cogen ambient
   days at B = 262144, a wide (2890, 201) table at B = 100, L = 96, and
   the EV step table's days flattened to rows;
8. ``cogen_segment`` vs its plain version, reward and info at rtol 2e-5 /
   atol 0.2, q99 |d reward| <= 1e-2, action rows bit-equal: 4096 x 96 on
   prescribed actions, 262144 x 96 in RNG mode with the plain version
   replaying the kernel's action rows;
9. in-kernel draws at 262144 x 96: Box components scaled to [0, 1) mean
   0.5 +- 0.005, switch frequency 0.5 +- 0.005, each bay 1/12 +- 0.002;
10. the cogen main path with the cogen counts from 0: the simulation tier
    (``CogenEnv.fused_rollout`` at 262144 x 96), two PPO train steps at
    8192 x 96 (H = 256, 24 minibatches, 4 epochs, f32 obs, reward_scale
    1e-4) and the lr=0 step at 1024 envs (|pg_loss| < 1e-5); then the
    kernels, the whole simulation-tier call and the plain version timed.

``python3 chip_smoke.py --profile`` adds each trainer's phases (rollout,
re-scoring + GAE, minibatch updates) on the host clock with
``torch.cuda.synchronize()`` between them, and the device's busy time over
one whole train step from ``torch.profiler``.

Every phase raises on failure (exit code 1). The line before the last is
a JSON object with, for each kernel, its launches in its slice's main-path
run (phases 5-6 and 10), its largest difference from the plain version,
its time, the plain version's and the library call's, and its bound (the
least time the card could take: the larger of its bytes over the memory
rate and its operations over the peak rate for their type); the last line
is ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one.
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
COGEN_SIM, COGEN_TRAIN, COGEN_STEPS, COGEN_CHECK = 262144, 8192, 96, 4096
# NVIDIA H100 SXM peaks (data sheet, dense, 700 W): HBM bytes/s, float32
# FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12


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


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time per call of the CUDA kernels whose name holds
    ``kernel``, from ``torch.profiler`` over ``reps`` calls after one
    warm-up call: the kernel alone, without the host time of its wrapper's
    checks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_dev_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    if us == 0:
        fail(f"the profiler saw no device time of {kernel}")
    return us / reps / 1e3


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def q(x, p):
    return float(np.quantile(x.detach().float().cpu().numpy(), p))


def bound(n_bytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their types' peak rates."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = (f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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

    # device-side kernels and copies only: CPU ops carry their kernels'
    # time as well, and device-side user annotations (Optimizer.step) span
    # kernels that are counted on their own
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print(f"profile: the trace holds no device time (not measured) "
              f"{tag}")
        return
    print(f"profile: traced train step {traced_ms:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / step_ms:.1%} of the untraced "
          f"step {step_ms:.1f} ms {tag}")
    for e in events[:10]:
        print(f"  {_dev_us(e) / 1e3:9.1f} ms device  {e.count:6d} calls  "
              f"{e.key[:90]}")


def check_cogen(case: str, ko, ro, tag: str) -> float:
    """``cogen_segment`` (30, T, B) rows against its plain version: action
    rows bit-equal, reward and info rows at rtol 2e-5 / atol 0.2 (relus at
    active constraint boundaries times the 1000 penalties amplify ulps),
    q99 |d reward| <= 1e-2. Returns max |d reward|."""
    import torch
    if not torch.equal(ko[:15], ro[:15]):
        fail(f"cogen_segment {case}: action rows differ")
    d = (ko[15:] - ro[15:]).abs()
    dr = d[0]
    print(f"cogen_segment {case}: reward max|d| {dr.max():.3e} q99 "
          f"{q(dr, 0.99):.3e} mean {dr.mean():.3e}; info max|d| "
          f"{d[1:].max():.3e}; entries off by > 0: "
          f"{float((d > 0).float().mean()):.2e} {tag}", flush=True)
    torch.testing.assert_close(ko[15:], ro[15:], rtol=2e-5, atol=0.2)
    if not q(dr, 0.99) <= 1e-2:
        fail(f"cogen_segment {case}: q99 |d reward| above 1e-2")
    return float(dr.max())


def check_draws(a, low, high, tag: str):
    """In-kernel action draws (T, B, 15): Box components scaled to [0, 1)
    mean 0.5 +- 0.005, switches 1 at frequency 0.5 +- 0.005, bays in 1..12
    at 1/12 +- 0.002 each."""
    import torch
    from sustaingym_tpu_torch.envs.cogen.env import BAYS_IDX, BINARY_IDX
    a = a.reshape(-1, 15)
    box = [i for i in range(15) if i not in BINARY_IDX + (BAYS_IDX,)]
    u = (a[:, box] - low[box]) / (high[box] - low[box])
    box_means = u.mean(0).tolist()
    switch = a[:, list(BINARY_IDX)]
    switch_freq = switch.mean(0).tolist()
    bays = a[:, BAYS_IDX]
    counts = torch.bincount(bays.long(), minlength=14).tolist()
    shares = [c / bays.numel() for c in counts[1:13]]
    print(f"cogen draws: {a.shape[0]} actions; box means "
          f"{min(box_means):.6f}..{max(box_means):.6f} (min u "
          f"{float(u.min()):.3e}, max u {float(u.max()):.6f}); switch "
          f"frequencies {min(switch_freq):.6f}..{max(switch_freq):.6f}; bay "
          f"shares {min(shares):.6f}..{max(shares):.6f} {tag}", flush=True)
    if not (all(abs(m - 0.5) <= 0.005 for m in box_means)
            and float(u.min()) >= 0.0 and float(u.max()) < 1.0 + 1e-6
            and bool(((switch == 0) | (switch == 1)).all())
            and all(abs(f - 0.5) <= 0.005 for f in switch_freq)
            and bool(torch.equal(bays, bays.floor()))
            and counts[0] == 0 and sum(counts[13:]) == 0
            and all(abs(x - 1 / 12) <= 0.002 for x in shares)):
        fail("cogen in-kernel draws off")


def cogen_slice(tag: str, want_profile: bool) -> list:
    """Phases 7-10 (module docstring); returns the two kernels' entries of
    the ``kernels`` line."""
    import torch
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.ops.cuda import cogen_rollout as KB
    from sustaingym_tpu_torch.ops.cuda import exog_gather as KA
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    env, p = make("cogen", device=dev)
    L, C = p.timesteps_per_day, p.ambients.shape[2]
    rows = p.ambients.shape[1]
    flat = p.ambients.reshape(-1, C)
    B, T = COGEN_SIM, COGEN_STEPS

    # ---- 7. episode_slice_gather vs plain, bit-equal --------------------
    ev_env, ev_p = make("evcharging", device=dev)
    ev_days = torch.randint(ev_p.n_days, (CHECK_BATCH,), generator=gen,
                            device=dev)
    wide = torch.rand((2890, 201), generator=gen, device=dev)
    days = torch.randint(p.n_days - 1, (B,), generator=gen, device=dev)
    gather_cases = [
        (f"cogen ambient days B={B} L={rows}", flat, days * rows, rows),
        ("wide (2890, 201) B=100 L=96", wide,
         torch.randint(2890 - 96 + 1, (100,), generator=gen, device=dev), 96),
        (f"EV step table days B={CHECK_BATCH} L={STEPS}",
         ev_p.step_table.reshape(-1, ev_p.step_table.shape[2]),
         ev_days * ev_p.step_table.shape[1], STEPS),
    ]
    gather_err = 0.0
    for case, table, starts, length in gather_cases:
        ko = KA.episode_slice_gather(table, starts, length)
        ro = KA.episode_slice_gather_ref(table, starts, length)
        equal = torch.equal(ko, ro)
        gather_err = max(gather_err, float((ko - ro).abs().max()))
        print(f"episode_slice_gather {case}: bit-equal {equal} {tag}",
              flush=True)
        if not equal:
            fail(f"episode_slice_gather {case}: differs from plain")
    del ko, ro, ev_p, ev_env
    starts = days * rows
    gather_ms = device_ms(lambda: KA.episode_slice_gather(flat, starts, rows),
                          "slice_gather_kernel", 20)
    gather_call_ms = cuda_ms(lambda: KA.episode_slice_gather(flat, starts,
                                                             rows), 20)
    gather_plain_ms = cuda_ms(lambda: KA.episode_slice_gather_ref(
        flat, starts, rows), 20)
    gather_bound = bound(B * rows * C * 4 + nbytes(flat, starts))
    print(f"episode_slice_gather B={B} L={rows} C={C}: kernel "
          f"{gather_ms:.4f} ms (device), wrapper call with its range check "
          f"{gather_call_ms:.4f} ms; plain (= library call) "
          f"{gather_plain_ms:.4f} ms; bound {gather_bound[0]:.4f} ms "
          f"({gather_bound[1]}) {tag}", flush=True)

    # ---- 8. cogen_segment vs plain ---------------------------------------
    low = torch.as_tensor(env.action_space(p).low, dtype=torch.float32,
                          device=dev)
    high = torch.as_tensor(env.action_space(p).high, dtype=torch.float32,
                           device=dev)
    cdays = days[:COGEN_CHECK]
    cprev = env.sample_action(p, gen, COGEN_CHECK)
    acts = low + torch.rand((T, COGEN_CHECK, 15), generator=gen,
                            device=dev) * (high - low)
    seg_err = check_cogen(
        f"{COGEN_CHECK}x{T} prescribed actions",
        KB.cogen_segment(p, cdays, cprev, T, actions=acts),
        KB.cogen_segment_ref(p, cdays, cprev, T, actions=acts), tag)
    prev = env.sample_action(p, gen, B)
    ko = KB.cogen_segment(p, days, prev, T, seed=32)
    a = ko[:15].permute(1, 2, 0).contiguous()
    seg_err = max(seg_err, check_cogen(
        f"{B}x{T} in-kernel draws", ko,
        KB.cogen_segment_ref(p, days, prev, T, actions=a), tag))
    del ko

    # ---- 9. in-kernel draws ------------------------------------------------
    check_draws(a, low, high, tag)
    del a

    # ---- 10. the cogen main path: counts from 0 -----------------------------
    KA.episode_slice_gather.launches = 0
    KB.cogen_segment.launches = 0
    sim_gen = torch.Generator(device=dev).manual_seed(33)
    roll = env.fused_rollout(p, B, T, generator=sim_gen)
    if roll.reward.shape != (T, B) or roll.obs["TAMB"].shape != (T, B, 4) \
            or not bool(torch.isfinite(roll.reward).all()):
        fail("cogen simulation tier: bad rewards or obs")
    mean_reward = float(roll.reward.mean())
    del roll
    cfg = PPOConfig(num_envs=COGEN_TRAIN, hidden=HIDDEN, minibatches=24,
                    epochs=4, reward_scale=1e-4)
    init_state, train_step = make_train_step(env, p, cfg)
    tgen = torch.Generator(device=dev).manual_seed(34)
    carry = init_state(tgen)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, tgen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        m = {key: float(v) for key, v in metrics.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"cogen train step {i}: non-finite metrics {m}")
        print(f"cogen train step {i}: {dt:.3f} s = "
              f"{COGEN_TRAIN * T / dt:.0f} env-steps/s; {json.dumps(m)} "
              f"{tag}", flush=True)
    cfg0 = PPOConfig(num_envs=CHECK_BATCH, hidden=HIDDEN, minibatches=4,
                     epochs=1, lr=0.0, reward_scale=1e-4)
    init0, step0 = make_train_step(env, p, cfg0)
    _, m0 = step0(init0(tgen), tgen)
    pg0 = float(m0["pg_loss"])
    print(f"cogen lr=0 train step at {CHECK_BATCH} envs: pg_loss {pg0:.3e} "
          f"{tag}", flush=True)
    if not abs(pg0) < 1e-5:
        fail(f"cogen lr=0 exact-ratio invariant broken: pg_loss {pg0}")
    launches = {"episode_slice_gather": KA.episode_slice_gather.launches,
                "cogen_segment": KB.cogen_segment.launches}
    if min(launches.values()) == 0:
        fail(f"a kernel of the cogen main path never launched: {launches}")
    if want_profile:
        profile_train_step(train_step, carry, tgen, cfg, tag)

    seg_ms = device_ms(lambda: KB.cogen_segment(p, days, prev, T, seed=35),
                       "cogen_segment_kernel", 10)
    seg_call_ms = cuda_ms(lambda: KB.cogen_segment(p, days, prev, T,
                                                   seed=35), 10)
    seg_plain_ms = cuda_ms(lambda: KB.cogen_segment_ref(p, days, prev, T,
                                                        seed=35), 1)
    sim_ms = cuda_ms(lambda: env.fused_rollout(p, B, T, generator=sim_gen), 3)
    seg_bound = bound(4 * 30 * T * B + nbytes(p.ambients, days, prev),
                      f32_ops=KB.OPS_PER_STEP * T * B)
    steps = B * T
    print(f"cogen simulation tier {B}x{T}: whole fused_rollout call "
          f"{sim_ms:.3f} ms = {steps / sim_ms * 1e3:.0f} env-steps/s; "
          f"cogen_segment kernel {seg_ms:.3f} ms (device) = "
          f"{steps / seg_ms * 1e3:.0f} env-steps/s, wrapper call "
          f"{seg_call_ms:.3f} ms, bound "
          f"{seg_bound[0]:.3f} ms ({seg_bound[1]}); plain {seg_plain_ms:.3f} "
          f"ms = {steps / seg_plain_ms * 1e3:.0f} env-steps/s; mean reward "
          f"{mean_reward:.3f}; launches {launches} {tag}", flush=True)

    return [
        {"name": "episode_slice_gather", "route": "cuda",
         "source": "sustaingym_tpu_torch/ops/cuda/csrc/exog_gather.cu",
         "replaces": "sustaingym_tpu/ops/pallas/exog_gather.py:100",
         "launches": launches["episode_slice_gather"],
         "max_abs_err": gather_err, "ms": gather_ms,
         "plain_ms": gather_plain_ms, "bound_ms": gather_bound[0],
         "bound_by": gather_bound[1], "library_ms": gather_plain_ms},
        {"name": "cogen_segment", "route": "cuda",
         "source": "sustaingym_tpu_torch/ops/cuda/csrc/cogen_rollout.cu",
         "replaces": "sustaingym_tpu/ops/pallas/cogen_rollout.py:206",
         "launches": launches["cogen_segment"], "max_abs_err": seg_err,
         "ms": seg_ms, "plain_ms": seg_plain_ms, "bound_ms": seg_bound[0],
         "bound_by": seg_bound[1], "library_ms": None},
    ]


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
    sources = ("ev_rollout", "exog_gather", "cogen_rollout")
    build.load_libraries(sources, verbose=True)
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.3f} s {tag}", flush=True)

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
                    epochs=4, obs_bf16=True)
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
                     epochs=1, lr=0.0, obs_bf16=True)
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

    # bounds at the main path's shapes (caltech, projection on)
    m2, iters = int(p.proj.C.shape[0]), int(p.proj.iters)
    # per env step: 2 mat-vecs per FISTA iteration, the final C' y and the
    # reward's C p, each 2 m2 n operations
    step_ops = (2 * iters + 2) * 2 * m2 * n
    seg_bound = bound(nbytes(p.step_table) + SIM_BATCH * (8 + 16 * STEPS),
                      f32_ops=SIM_BATCH * STEPS * step_ops)
    pol_bound = bound(
        nbytes(p.step_table, p.moer, *w.__dict__.values())
        + TRAIN_ENVS * (8 + STEPS * (16 + 2 * (D + n))),
        f32_ops=TRAIN_ENVS * STEPS * step_ops,
        bf16_ops=TRAIN_ENVS * STEPS * 2 * (D * HIDDEN + HIDDEN * HIDDEN
                                           + HIDDEN * n))
    src = "sustaingym_tpu_torch/ops/cuda/csrc/ev_rollout.cu"
    kernels = [
        {"name": "ev_segment", "route": "cuda", "source": src,
         "replaces": "sustaingym_tpu/ops/pallas/ev_rollout.py:337",
         "launches": launches["ev_segment"],
         "max_abs_err": err["ev_segment"], "ms": seg_ms,
         "plain_ms": seg_plain_ms, "bound_ms": seg_bound[0],
         "bound_by": seg_bound[1], "library_ms": None},
        {"name": "ev_policy_segment", "route": "cuda", "source": src,
         "replaces": "sustaingym_tpu/ops/pallas/ev_rollout.py:674",
         "launches": launches["ev_policy_segment"],
         "max_abs_err": err["ev_policy_segment"], "ms": pol_ms,
         "plain_ms": pol_plain_ms, "bound_ms": pol_bound[0],
         "bound_by": pol_bound[1], "library_ms": None},
    ]
    kernels += cogen_slice(tag, want_profile)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
