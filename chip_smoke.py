#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's five slices through their public entry points, after
checking each hand-written kernel against its plain PyTorch version on the
card. Every trainer runs its train steps as CUDA graphs (``parallel/
ppo.py``, ``core/graph.py``): the episodic rollout's step loop (one replay
per episode after an eager episode start), the re-scoring with GAE, and
each minibatch update (one replay per minibatch), captured at its first
train step. Each trainer, in every slice below:

- takes its train steps captured, the first one's graph warm-ups and
  captures printed apart, with the trainer's peak device memory;
- runs its lr=0 exact-ratio step through the captured path (|pg_loss| <
  1e-5);
- after its slice's launches are read: one train step captured against
  the same step eager (``capture=False``) from the same carry and
  generator state, at 1024 envs with the main path's minibatch rows, the
  largest parameter and metric differences printed, gated by
  ``CAPTURE_GATE``; then its graphs are freed.

The kernel wrappers count their kernels' launches on the card: a captured
loop's wrappers count at its warm-up, the capture takes its count back
(nothing runs), and each replay adds the launches it holds
(``core/graph.py::count_launches``).

Slice 1, PPO on EVChargingEnv with the action projection on:

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
   N(0, 1) mean and variance; then ``ppo_gauss_loss``, the PPO loss
   head's kernel, vs its plain version on the same card tensors at the
   trainer's minibatch (24576 x 54, ``mu`` and ``value`` the strided
   parts of one (24576, 55) head product, ratios across both sides of
   the clip, both signs of the advantage): each output within
   ``LOSS_GATE`` of its scale (``check_ppo_loss``); then ``ppo_trunk``,
   the trunk's glue passes, vs their plain versions on the same card
   tensors at the trainer's minibatch (24576 x 256, the second pass of
   the backward with the 146-wide obs copy): y, h, d, hf and the copy
   bit-equal, the bias sums within ``TRUNK_GATE`` of each column's sum
   of |d|, two calls bit-equal (``check_ppo_trunk``);
5. simulation tier: ``EVChargingEnv.fused_rollout`` at 32768 x 288,
   projection on;
6. trainer: two PPO train steps at 8192 envs x 288 steps, H = 256, bf16
   obs, 96 minibatches, 4 epochs; then the lr=0 exact-ratio check;
   ``ppo_gauss_loss``'s launches over both must be one a minibatch plus
   one warm-up for each trainer's captured update (2 x 384 + 1 and 4 + 1);
   ``ppo_trunk``'s four a minibatch and two a scoring, with each
   trainer's warm-ups of its captured update and scoring (2 x 1538 + 6
   and 18 + 6);
   then the kernels' device time (CUDA events around the kernel's C
   entry point, ``device_ms``; the loss head's at the check's inputs),
   the whole
   simulation-tier call and the plain versions (CUDA events), and
   ``ev_segment``'s CTAs resident per SM and waves. Before the
   main path, ``ev_policy_segment`` at 8192 x 288 is also timed with the
   projection off (the actor / projection split), its CTAs resident per
   SM are read, and the actor's three bf16 ``torch.matmul`` calls per step
   over 288 steps are timed as a yardstick the port never calls.

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

Slice 3, DataCenterEnv and ElectricityMarketEnv:

11. ``dc_segment`` vs its plain version, bit-equal on every row: 4096 x 672
    on prescribed VCCs in [-0.1, 1.1), 262144 x 672 in RNG mode with the
    plain version replaying the kernel's VCC row; the draws' mean 0.5 +-
    0.005, min >= 0, max < 1;
12. the datacenter main path with its counts from 0: the simulation tier
    (``DataCenterEnv.fused_rollout`` at 262144 x 672), two PPO train steps
    at 4096 x 672 (H = 256, 84 minibatches, 4 epochs, f32 obs) and the
    lr=0 step at 1024 envs; then the kernel, the whole call and the plain
    version timed;
13. ``pdhg_solve_paired`` vs its plain version on the SCED operator at
    B = 4096 (``check_solve``: the share of each output's entries outside
    rtol 1e-4 / atol 2e-3 and max |d| over its largest value each at most
    1% or twice those of the plain version against itself summing in
    float64, the solve's own sensitivity to its sums): problems
    drawn as ``tests/test_ops_pallas.py:496-505`` at 50 iterations; the
    market's own problems (reset envs, bids uniform over the action box)
    at the cold budget of 200, with price and battery dispatch q99 |d| <
    0.05 and max < 2.0, and at the warm budget of 40; then
    ``batch_unroll`` at 4096 x 288 on the same prescribed bids and days,
    kernel against plain, clearing price mean |d| < 0.25 and q99 < 2.0
    $/MWh (the bounds of ``tests/test_electricitymarket.py:324-346``),
    max |d| within 2.0 or twice that of the plain version against itself
    summing in float64;
14. the market main path with its count from 0: the simulation tier
    (``batch_rollout`` with the random policy at 4096 x 288 through the
    captured episode loop, a solve launch per step inside the graph: 2 x
    288 launches at the first call (warm-up and one replay), 288 at the
    second (one replay); bit-equal to the eager ``batch_unroll`` from the
    same generator state), two PPO train steps at 4096 x 288 (H = 256, 36 minibatches, 4
    epochs, f32 obs) with Box bids and two with ``discrete=True``
    (Discrete(3) bids, the categorical head), each with its lr=0 step at
    1024 envs; then the kernel's
    time per warm and per cold solve (CUDA events over back-to-back
    launches, which its wrapper never separates by a host wait), the
    plain warm solve, the kernel's CTAs resident per SM, and a warm solve's
    products as 80 bf16 ``torch.matmul`` calls (K x-bar and K' w at B =
    4096), a yardstick the port never calls.

Slice 4, BuildingEnv, on a 6-zone office (one storey of a core and four
perimeter zones under an attic) and a seeded hourly year in Tucson's range
that ``write_building_tables`` writes, compiled by
``generate_building_params`` (OfficeSmall U-factors; 105108 five-minute
weather rows):

15. ``building_segment`` vs its plain version, every TimeStep field, bit
    for bit as the target and max |d| <= 1e-5 on zone temperatures and
    rewards as the gate: 4096 x 288 on prescribed actions in [-ac, ac),
    524288 x 288 in RNG mode with the plain version replaying the kernel's
    recorded actions; the draws' a / ac mean 0 +- 0.002, in [-1, 1);
16. ``building_policy_segment`` vs its plain version at 1024 x 288 and
    8192 x 288, H = 256, on prescribed noise, with the JAX package's bounds
    for its kernel (``tests/test_ops_pallas.py:461-478``), each with the
    drift diagnostic of ``policy_drift`` (a print, not a gate); then
    N(0, 1) draws with a zeroed mu and log sigma = 0: mean 0 +- 0.01, var
    1 +- 0.01;
17. the building main path with its counts from 0: the simulation tier
    (``BuildingEnv.fused_rollout`` at 524288 x 288, finite rewards, done at
    t = 287 only), two PPO train steps at 8192 x 288 (H = 256, 96
    minibatches, 4 epochs, bf16 obs: the fused path) and one with float32
    obs (the episodic path through ``batch_unroll`` and the gather), each
    with its lr=0 step at 1024 envs; then both kernels timed (CUDA events
    over back-to-back launches of their C entry points, which no host wait
    separates), the whole simulation-tier call and the plain versions; the
    policy kernel's shared-memory plan, CTAs resident per SM and waves,
    and its actor's three bf16 ``torch.matmul`` calls per step over 288
    steps, a yardstick the port never calls.

Slice 5, EV's lockstep and generic training paths:

18. ``ev_segment``'s ADMM branch (``proj_method="admm"``, 30 iterations)
    vs its plain version with ``check_segment``'s bounds (those of the JAX
    ADMM kernel test, ``tests/test_ops_pallas.py:64-103``): both sites at
    1024 x 288 on prescribed actions, caltech at 32768 x 288 in RNG mode
    with the plain version replaying the kernel's recorded actions; then
    the ADMM simulation tier (``fused_rollout`` at 32768 x 288, its count
    from 0), the kernel timed against the dual branch at the same shape,
    its plain version, its mat-vecs as ``torch.matmul`` calls (a
    yardstick the port never calls), and its bound from the K mat-vecs
    and the C mat-vecs it ran, with the kernel's envs a warp, CTAs and
    warps resident per SM, registers and spills;
19. GMM traces: ``ev_segment`` and ``ev_policy_segment`` vs their plain
    versions at 1024 x 288 on a 200-day caltech Summer 2021 bank
    (``trace="gmm"``), and the simulation tier at 32768 x 288 on it;
20. the EV float32 episodic trainer (8192 x 288, H = 256, 96 minibatches,
    4 epochs: ``batch_unroll``'s step loop captured): two steps, the lr=0
    step, captured against eager over one step;
21. the EV generic trainer (8192 envs, ``rollout_len`` 64, 16
    minibatches, H = 256: the JAX CLI's default rollout, envs carried
    across train steps): three steps, the lr=0 step, captured against
    eager over two steps;
22. the CLI: ``train.main(["--rollout-len", "64", "--eval-every", "1",
    "--iterations", "2", ...])`` into a temporary directory, then its
    ``eval_results.csv`` (two finite rows) and ``best_model``.

Slice 6, the multi-agent views and their PPO paths (no env kernel on
this path: the views step through the PyTorch step functions; the shared
Gaussian policies of phases 24 and 26 run their loss head as
``ppo_gauss_loss``; every launch count is set to 0 before phase 23 and
printed after phase 27). Each
trainer takes two captured train steps (agent-steps/s printed), its lr=0
step and one step captured against eager under ``CAPTURE_GATE``; the
MA-EV trainers take both at their own 512 envs (``check_captured`` at
1024 would hold a (288, 1024, 54, 146) obs block and its float32
activations):

23. MA-EV on the uniform-obs path (bench ``MA EV``: caltech, 54 station
    agents, 512 x 288, 36 minibatches, bf16 obs, projection off,
    ``periods_delay`` 0);
24. MA-EV with ``periods_delay`` 2 (bench ``MA EV delay2``: the agent axis
    as batch, episodic through the view's ``batch_unroll``);
25. MA cogen with per-agent stacked policies (bench ``MA cogen``: 4096 x
    96, 24 minibatches; lr=0 and the captured check at 1024 envs);
26. MA building at 1024 envs x 288 on the synthetic tables (the agent
    axis as batch, the generic path), 36 minibatches;
27. discrete MA-EV (``discrete_bins`` 5: the categorical head over (54,
    5) logits, the generic path), 512 envs, ``rollout_len`` 64, 16
    minibatches.

Slice 7, the off-policy learners (SAC, double-DQN, TD3-style DDPG over
the on-device replay ring, ``parallel/offpolicy.py``: the rollout into the
ring and one update are each a CUDA graph; they step through the generic
autoreset step, as the JAX package's learners do. On the market that
step solves its SCED LP with one ``pdhg_solve_paired`` launch, each env at
its own budget; no other kernel is on this path). Each of the bench's six
``OFF_POLICY`` trainers takes two captured train steps (env- or
agent-steps/s, the graphs' warm-up and capture seconds, the peak device
memory of the first step and of the second, whose difference is the
capture's extra; every launch count set to 0 before them and read after
them: on the market trainers ``pdhg_solve_paired`` once a rollout step
and once for each one-step rollout graph's warm-up, 2 x rollout_len + 1,
on the others no kernel at all), its
lr=0 step (``alpha_lr`` 0 for SAC: every online weight and ``log_alpha``
bit-equal, the targets' Polyak step of equal values printed) with finite
losses, and one train step captured against eager under
``CAPTURE_GATE`` (every weight, target, optimizer state, ``log_alpha``,
the ring, ``written``, DQN's ``iter``, the carried obs, the metrics and
the generator state), at ``CHECK_BATCH`` envs, DQN MA EV at its own 128;
over each phase the launches are read again: phases 29, 30 and 32 launch
``pdhg_solve_paired`` and no other kernel, phases 28, 31, 33 and 34 none:

28. SAC on the synthetic building, 4096 x 64;
29. DQN on the discrete market, 4096 x 32;
30. DDPG on the market, 4096 x 32;
31. SAC on EV with the projection off, 2048 x 64;
32. SAC on the market, 4096 x 32;
33. DQN on discrete MA-EV (54 agents, 5 bins), 128 x 32, capacity 64;
34. the CLI: ``train.main(["--algo", "sac", "--eval-every", "1", ...])``
    on EV into a temporary directory: two train steps, then its
    ``eval_results.csv`` (two finite rows), ``best_model`` and a resume.

Slice 8, the solve kernel's per-env budgets and the EV baselines:

35. ``pdhg_solve_paired`` with (B,) int32 budgets on the market's own
    problems at B = 4096 (``market_problems``: numpy-seeded days and
    bids), the cold budget of 200 and the warm one of 40 drawn per env:
    against its plain version under ``check_solve``'s gates; each env
    bit-equal to a launch with one int budget, its own; the int launches'
    outputs (cold, then warm) bit-equal to the kernel before per-env
    budgets, by their SHA-256 (``PARENT_PDHG_INT_DIGEST``); the mixed
    launch and the uniform cold and warm ones timed (CUDA events);
36. the EV baselines on the card against their CPU runs:
    ``offline_optimal_schedule`` of the busiest day and ``batch_run``'s
    lockstep loop (``algorithms.batch_returns``) with the greedy policy
    over 64 seeds x 288 steps (``baselines_on_card``).

Slice 9, the PPO update's bf16 GEMMs, the reset schedule and ranks:

37. the learner's three bf16 products at the EV trainer's minibatch rows
    (24576, H = 256) as bf16 GEMMs with float32 output, and the float32
    route of the same values, against float64 (``GEMM_GATE``), timed;
38. the captured EV and fused building trainers (8192 x 288), two train
    steps each, and their update's device time by kind
    (``update_split``);
39. the generic rollouts' reset schedule: the EV generic trainer (8192 x
    64) and SAC EV (2048 x 64), nine rollout phases each from a fresh
    carry (two with a reset), timed, the guard at 0; the EV generic
    trainer captured against eager over five steps that cross the reset;
40. two gloo ranks sharing the card: the policy kernels' ``env_offset``
    launches bit-equal to the full launch's rows at 8192 x 288; two dp = 2
    train steps of the EV fused trainer (8192 x 288) against one rank on
    the same global batch (parameters bit-equal across the ranks, each
    rank's launches), the lr = 0 step at 1024 envs (``DP_GATE``), a dp =
    2 SAC EV step and a dp = 1 x mp = 2 MA cogen step (and two at lr = 0:
    the exact-ratio invariant on each rank); each rank's wall time and peak memory
    (``distribution_slice``).

Slice 10, the host side: the debug checks, the examples and ``--profile``
(every launch count set to 0 before phases 41 and 43 and read after each;
their launches join the kernels' line):

41. ``utils.debug.validate_batch_rollout`` over one whole episode of each
    env of ``DEBUG_RUNS`` at the bench's widths (EV, building on the
    synthetic tables and cogen at 8192 envs, datacenter and market at
    4096, MA EV 512 x 54 agents, MA cogen 4096, MA building 1024), with
    ``check_bounds`` as ``tests/test_torch_debug.py`` settles it (the
    building's and MA building's bounds run first and must fail with the
    JAX env's message); the checked run against the same rollout
    unchecked from the same generator state, seconds printed and reward
    sums bit-equal, in turns (checked, unchecked, unchecked, checked),
    and the kernel launches; then the NaN env at 8192
    envs: ``validate_batch_rollout`` raises "non-finite reward", and a
    checked step loop captured as a CUDA graph raises it after its
    replay, its outputs bit-equal to the eager loop's;
42. ``examples.validate_envs.main(["--batch", "4096", ...])`` over the
    five envs (the building on the synthetic tables), printing its stats
    lines, and ``examples.train_multiagent_cogen.main([...])`` for two
    iterations at 4096 x 96 into a temporary directory;
43. ``examples.train_ppo.main([..., "--iterations", "4", "--profile"])``
    at the bench's EV fused trainer configuration (8192 x 288, H = 256,
    bf16 obs, 96 minibatches) into a temporary directory, in a child
    process (``chip_smoke.py --profile-child DIR``, which sets the
    launch counts to 0, runs it and prints them: a fresh process, as a
    user's ``--profile`` run is, whose trace no earlier trace of this long
    process can thin out): its trace
    parsed, its annotations spanning iterations 1-3, its kernel events
    holding ``ev_policy_segment``; the device-busy share over the traced
    iterations and the five kernels with the most device time printed;
    ``plot_utils.read_train_log`` reads back 4 rows.
44. the GMM fit of ``data/ev_gmm.py`` (``fit_gmm``'s EM): 5832 sessions
    drawn from the committed jpl Summer 2019 mixture (``sample_gmm``,
    random_state 0) and kept inside the feature domain (5821 rows); the
    host's k-means labels at k = 30, seed 42 (``kmeans_labels``); the EM
    (``em_fit``) from them on the card, on the CPU, and on the card again:
    the same iterations and convergence, the lower bound within 1e-8,
    weights, means and covariances within 1e-6 (``GMM_GATE``); printed:
    the lower bound, iterations, the card's (first and second call) and
    the CPU's seconds, and the generating mixture's mean log-likelihood
    on the same points (not gated: a fit at another seed reads below it).

``python3 chip_smoke.py --profile`` adds, for each trainer captured and
the same trainer eager (``capture=False``, the before): its phases
(rollout, re-scoring + GAE, minibatch updates) on the host clock with
``torch.cuda.synchronize()`` between them; the host's CUDA runtime calls
in each phase (``cudaLaunchKernel``, ``cudaGraphLaunch``, memcpy and
memset, from ``torch.profiler``) and the update's calls per minibatch;
the graphs' warm-up and capture + instantiate time; and the device's busy
time over one whole train step from ``torch.profiler``; for EV and the
fused building trainer the updates' device time split into GEMMs, dtype
casts (the bf16 rounding), other copies, the foreach Adam and gradient
clip, and the loss (``update_split``; also ``tools/update_split.py``); for the EV generic trainer the share of its captured
rollout that its whole-batch resets take (captured alone). For each
off-policy trainer, captured and eager: the rollout, the updates and the
train step on the host clock, and the device's busy time over a captured
step; the market trainers' share of their captured rollout spent in the
SCED solve (``clear_market`` over the rollout's steps, captured alone at
the same batch and state), and the whole-batch reset's share of the SAC
EV and DQN MA EV rollouts (``env.reset`` of the batch, captured alone,
``rollout_len`` times).

At its end the script checks the JAX package's tree: every file under
``sustaingym_tpu/`` (but ``__pycache__``) has the path, size and
``mtime_ns`` it had when ``main`` began, and none is new. It prints the
count of files checked and the port's pack directory with what it holds
(``data/paths.py``: the port writes its packs there and only reads the
JAX package's), and exits 1 naming each file new, changed or gone.

Every phase raises on failure (exit code 1). The line before the last is
a JSON object with, for each TPU kernel's counterpart (the slice gather
twice: it replaces both TPU gathers), its launches in its slice's
main-path run (phases 5-6, 10, 12, 14 and 17; the slice gather's in 10, 12
and 17; ``ppo_gauss_loss``, the port's own kernel with no TPU
counterpart, in phase 6; ``ev_segment_admm``, the ADMM branch of
``ev_segment``, in phase 18's simulation tier; ``pdhg_solve_paired`` in 14
and in the market
trainers' captured steps of 29, 30 and 32; and each kernel's launches in
phases 41 and 43), its largest difference from
the plain version (``pdhg_solve_paired``'s also over phase 35),
its time, the plain version's and the library call's, and its bound (the
least time the card could take: the larger of its bytes over the memory
rate and its operations over the peak rate for their type); the last line
is ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# the episodes' lengths; the configurations' batches and widths are those
# of sustaingym_tpu_torch/bench.py (trainer_configs)
STEPS, CHECK_BATCH = 288, 1024
# the gate of check_captured, and why
CAPTURE_GATE = ("gate: bit-equal, the graph replays the eager step's "
                "kernels on the same inputs and Philox offsets")
# the bf16 GEMM gate: each output within GEMM_GATE * 2^-24 * sum_k
# |a_k b_k| of the float64 product of the same bf16 values (float32 sums
# of exact products, in any order)
GEMM_GATE = 64.0
# dp = 2 against one rank at lr = 0: every metric within rel of one
# rank's, |d| / max(|one rank|, floor) (the sums' order differs)
DP_GATE = (1e-3, 1e-5)
# the loss head's kernel against its plain version on the same float32
# inputs: each output's largest |d| over its scale (a gradient's largest
# entry; pg, vf and the loss the mean of the absolute per-row terms; ent
# the sum of its absolute terms), as tests/test_torch_gpu_kernels.py holds
# it against float64
LOSS_GATE = 1e-5
# the trunk's bias sums against the plain version's ``sum(0)`` on the same
# float32 gradient: |d| within TRUNK_GATE of the column's sum of |d| (the
# two sum in other orders; the elementwise outputs are held bit-equal)
TRUNK_GATE = 1e-5
COGEN_STEPS, COGEN_CHECK = 96, 4096
DC_STEPS, DC_CHECK = 672, 4096
MKT_STEPS = 288
BLD_CHECK = 4096
# device_ms' spin before each timed launch, ~1 ms at the H100's clock: it
# keeps the card busy while the host enqueues the start event and the launch
SPIN_CYCLES = 2_000_000
# NVIDIA H100 SXM peaks (data sheet, dense, 700 W): HBM bytes/s, float32
# FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# phase 44: the fit's data (site, period, sample_gmm's random_state), its
# components and seed, and the card's fit against the CPU's: weights,
# means and covariances (max |d|), lower bound (|d|)
GMM_DRAW, GMM_FIT, GMM_GATE = ("jpl", "Summer 2019", 0), (30, 42), (1e-6,
                                                                    1e-8)


def fail(msg: str):
    raise RuntimeError(msg)


def trainer_configs(label: str):
    """(cfg, cfg0) of trainer ``label`` of the bench's ``TRAINERS``: its
    ``PPOConfig`` and the lr=0 check's, at ``CHECK_BATCH`` envs, 4
    minibatches and one epoch."""
    from sustaingym_tpu_torch.bench import train_config
    return train_config(label), train_config(
        label, num_envs=CHECK_BATCH, minibatches=4, epochs=1, lr=0.0)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def tree_state(root: str) -> dict:
    """Every file under ``root`` but ``__pycache__``: its path relative to
    ``root`` -> (size, mtime_ns)."""
    out = {}
    for d, subdirs, files in os.walk(root):
        subdirs[:] = [s for s in subdirs if s != "__pycache__"]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.relpath(os.path.join(d, f), root)] = (
                st.st_size, st.st_mtime_ns)
    return out


def check_jax_tree(root: str, before: dict) -> int:
    """Compares the JAX package's tree with ``before`` and prints what the
    port's pack directory holds; 1, naming each file, where a file under
    ``root`` is new, changed or gone, else 0."""
    from sustaingym_tpu_torch.data import paths
    after = tree_state(root)
    moved = sorted(f for f in before.keys() | after.keys()
                   if before.get(f) != after.get(f))
    held = (sorted(os.path.relpath(os.path.join(d, f), paths.PACKED_DIR)
                   for d, _, files in os.walk(paths.PACKED_DIR)
                   for f in files)
            if os.path.isdir(paths.PACKED_DIR) else None)
    print(f"tree check: {len(after)} files under sustaingym_tpu/ checked, "
          f"{len(moved)} new, changed or gone; the port's pack directory "
          f"{paths.PACKED_DIR} "
          f"{'is absent' if held is None else f'holds {held}'}", flush=True)
    for f in moved:
        state = ("new" if f not in before else "gone" if f not in after
                 else "changed")
        print(f"tree check: sustaingym_tpu/{f} {state}, (size, mtime_ns) "
              f"{before.get(f)} -> {after.get(f)}", flush=True)
    return 1 if moved else 0


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


def device_ms(fn, launch: str, reps: int) -> float:
    """Mean device time per call of the C entry point ``launch`` (the
    ``*_launch`` function of a bound kernel library), called once per call
    of ``fn``, over ``reps`` calls after one warm-up call: CUDA events
    recorded on the stream just before and just after the entry point, so
    the wrapper's range checks, which wait on the host, stay outside. A
    spin kernel queued before the start event keeps the card busy while
    the host enqueues the launch, so no host time falls inside the span.
    (The profiler's trace, used here before, lost most launches of one
    kernel in all of its retries late in this long process.)"""
    import torch
    from sustaingym_tpu_torch.ops.cuda import wrap
    fn()
    torch.cuda.synchronize()
    libs = [lib for lib in wrap._BOUND.values() if launch in vars(lib)]
    if len(libs) != 1:
        fail(f"device_ms: no bound library declares {launch}")
    lib, real = libs[0], getattr(libs[0], launch)
    spans = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        err = real(*args)
        end.record()
        spans.append((start, end))
        return err

    setattr(lib, launch, timed)
    try:
        for _ in range(reps):
            fn()
    finally:
        setattr(lib, launch, real)
    torch.cuda.synchronize()
    if len(spans) != reps:
        fail(f"device_ms: {len(spans)} calls of {launch} in {reps} calls")
    return sum(s.elapsed_time(e) for s, e in spans) / reps


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


def actor_bytes(w) -> int:
    """Bytes of a packed actor's weights, biases and sigma, each once."""
    return nbytes(w.w1, w.b1, w.w2, w.b2, w.wm, w.bm, w.sigma)


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


def free_cuda():
    """Releases what dropped trainers held: their graphs, pools and
    buffers."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


# host-side CUDA runtime calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
# the program's spans of the train step's phases (core/trace.py)
PHASES = ("ppo.rollout", "ppo.score", "ppo.update")

# (label, env, params, cfg, seed) of each trainer that ``--profile``
# profiles at the end of the run, after every kernel's device time is
# taken: the profiler's trace lost kernel launches after large traces
PROFILE_JOBS = []


def phase_launches(prof) -> dict:
    """The host's CUDA runtime calls that issue work (``LAUNCH_CALLS``)
    in each ``record_function`` range of ``PHASES`` of a trace."""
    from torch.autograd import DeviceType
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in PHASES and e.device_type == DeviceType.CPU}
    calls = {phase: {} for phase in ranges}
    for e in prof.events():
        if e.name not in LAUNCH_CALLS:
            continue
        for phase, r in ranges.items():
            if r.start <= e.time_range.start <= r.end:
                calls[phase][e.name] = calls[phase].get(e.name, 0) + 1
    return calls


def profile_train_step(label: str, train_step, carry, generator, cfg,
                       tag: str) -> float:
    """Two whole train steps under the program's trace recording
    (``core/trace.py``): the step's wall time (host clock, synchronised
    around it) and each phase's device time (its span's CUDA events); the
    graphs' warm-up and capture time; then one traced step
    (``torch.profiler`` and the recording: the phases are the program's
    ``ppo.*`` ranges): the host's launch calls in each phase and the
    device's busy time. Returns the rollout's device ms (the second
    step's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sustaingym_tpu_torch.core import trace

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    updates = cfg.epochs * cfg.minibatches
    for i in range(2):
        with trace.recording() as rec:
            _, step_ms = timed(lambda: train_step(carry, generator))
        ms = {s["name"]: s["device_ms"] for s in rec.snapshot()["spans"]
              if s["name"] in PHASES}
        roll_ms, score_ms, upd_ms = (ms[p] for p in PHASES)
        print(f"profile {label} {i}: train step {step_ms:.1f} ms; rollout "
              f"{roll_ms:.1f} ms, re-scoring + GAE {score_ms:.1f} ms, "
              f"{updates} minibatch updates {upd_ms:.1f} ms = "
              f"{upd_ms / updates:.3f} ms each (device) {tag}", flush=True)
    graphs = train_step.graphs
    if graphs is not None:
        print(f"profile {label}: {graphs.captures} graphs, warm-up "
              f"{graphs.warmup_s:.3f} s, capture + instantiate "
              f"{graphs.capture_s:.3f} s {tag}", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            trace.recording():
        _, traced_ms = timed(lambda: train_step(carry, generator))
    calls = phase_launches(prof)
    per_mb = sum(calls.get("ppo.update", {}).values()) / updates
    print(f"profile {label}: host launch calls per phase {calls}; update: "
          f"{per_mb:.3f} per minibatch {tag}", flush=True)

    # device-side kernels and copies only: CPU ops carry their kernels'
    # time as well, and device-side user annotations (Optimizer.step) span
    # kernels that are counted on their own
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print(f"profile {label}: the trace holds no device time (not "
              f"measured) {tag}")
        return roll_ms
    print(f"profile {label}: traced step {traced_ms:.1f} ms wall, device "
          f"busy {busy_ms:.1f} ms = {busy_ms / step_ms:.1%} of the untraced "
          f"step {step_ms:.1f} ms {tag}")
    for e in events[:10]:
        print(f"  {_dev_us(e) / 1e3:9.1f} ms device  {e.count:6d} calls  "
              f"{e.key[:90]}")
    return roll_ms


def update_kind(name: str) -> str:
    """The kind of one of the PPO update's device kernels, by its name.
    A copy kernel is a dtype cast (the bf16 rounding ``x.to(bf16).float()``
    and the bf16 obs read back as float32) when it is PyTorch's float ->
    bf16 copy or a ``direct_copy`` that loads or stores with a cast; any
    other copy (``torch.cat``, ``.contiguous``, a same-dtype gather) is
    kept apart, with the graph's memcpy nodes. Every kernel of no other kind is the loss (its forward
    and backward elementwise work and reductions)."""
    n = name.lower()
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "splitk",
                            "nvjet")):
        return "GEMMs"
    if "bfloat16_copy" in n or ("direct_copy" in n and (
            "withcast" in n or "gpu_kernel_impl<" in n)):
        return "dtype casts"
    if "copy" in n or "memcpy" in n:
        return "other copies"
    if "multi_tensor" in n or "foreach" in n:
        return "Adam and the gradient clip (foreach)"
    return "loss"


UPDATE_KINDS = ("GEMMs", "dtype casts", "other copies",
                "Adam and the gradient clip (foreach)", "loss")
# the trainers whose update ``--profile`` splits by kind
UPDATE_SPLIT = ("EV", "building fused")


def update_split(label: str, train_step, carry, generator, cfg, tag: str):
    """One traced run of the train step's minibatch updates
    (``torch.profiler``): its device time split into ``UPDATE_KINDS``
    (:func:`update_kind`), with each kind's top kernels (the copies' by
    their whole name, which shows the casts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    policy, opt = carry["policy"], carry["opt"]
    flat = train_step.score(policy, train_step.rollout(policy, generator,
                                                       carry))
    train_step.update(policy, opt, flat, generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step.update(policy, opt, flat, generator)
        torch.cuda.synchronize()
    kinds: dict[str, list] = {k: [] for k in UPDATE_KINDS}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or _dev_us(e) == 0 \
                or getattr(e, "is_user_annotation", False):
            continue
        kinds[update_kind(e.key)].append(e)
    total = sum(_dev_us(e) for v in kinds.values() for e in v) / 1e3
    if total == 0:
        print(f"profile {label} update split: the trace holds no device "
              f"time (not measured) {tag}", flush=True)
        return
    split = {k: sum(_dev_us(e) for e in v) / 1e3 for k, v in kinds.items()}
    print(f"profile {label} update split (device ms over "
          f"{cfg.epochs * cfg.minibatches} minibatch updates, total "
          f"{total:.1f}): "
          + ", ".join(f"{k} {ms:.1f} ({ms / total:.1%})"
                      for k, ms in split.items()) + f" {tag}", flush=True)
    for k, v in kinds.items():
        for e in sorted(v, key=_dev_us, reverse=True)[:3]:
            name = e.key if "copies" in k or "casts" in k else e.key[:80]
            print(f"  {k}: {_dev_us(e) / 1e3:8.1f} ms {e.count:6d} calls "
                  f"{name}")


def profile_trainers(tag: str):
    """``--profile``: each trainer of ``PROFILE_JOBS`` captured and the
    same trainer eager (``capture=False``, the before), each profiled by
    ``profile_train_step`` and freed."""
    import torch
    from sustaingym_tpu_torch.parallel import make_train_step
    for label, env, p, cfg, seed in PROFILE_JOBS:
        for capture in (True, False):
            free_cuda()
            init_state, step = make_train_step(env, p, cfg, capture=capture)
            tgen = torch.Generator(device=p.device).manual_seed(seed)
            carry = init_state(tgen)
            kind = "captured" if capture else "eager"
            roll_ms = profile_train_step(f"{label} {kind}", step, carry,
                                         tgen, cfg, tag)
            if label in UPDATE_SPLIT:
                update_split(f"{label} {kind}", step, carry, tgen, cfg,
                             tag)
            if label == "EV generic" and capture:
                # the whole-batch reset of every generic step, captured
                # alone rollout_len times at the trainer's batch
                rgen = torch.Generator(device=p.device).manual_seed(seed)

                def resets():
                    for _ in range(cfg.rollout_len):
                        env.reset(p, rgen, cfg.num_envs)
                reset_ms = captured_ms(resets, generators=(rgen,))
                print(f"profile {label}: {cfg.rollout_len} whole-batch "
                      f"resets at {cfg.num_envs} envs captured alone "
                      f"{reset_ms:.1f} ms = {reset_ms / roll_ms:.1%} of the "
                      f"captured rollout {roll_ms:.1f} ms {tag}", flush=True)
            del init_state, step, carry
    free_cuda()


def ppo_loss_inputs(rows: int, A: int, gen) -> tuple:
    """The loss head's arguments at ``rows`` x ``A`` on the card, as the
    fused EV update gives them: ``mu`` and ``value`` the two parts of one
    (rows, A + 1) head product, ``u`` drawn from the policy, ``logp_old``
    placing the ratios uniformly in [0.5, 1.7] (both sides of the clip at
    0.2) but none within 0.01 of a bound, where the rounding of either
    log-prob sum could take the other side of the clip; standard normal
    advantages and returns; clip 0.2, vf_coef 0.5, ent_coef 0.01."""
    import torch
    from sustaingym_tpu_torch.parallel import ppo
    dev = gen.device
    head = torch.randn((rows, A + 1), generator=gen, device=dev)
    log_std = -0.5 * torch.rand((A,), generator=gen, device=dev)
    mu, value = head[:, :A], head[:, A]
    u = mu + torch.exp(log_std) * torch.randn((rows, A), generator=gen,
                                              device=dev)
    ratio = 0.5 + 1.2 * torch.rand((rows,), generator=gen, device=dev)
    for b in (0.8, 1.2):
        ratio = torch.where((ratio - b).abs() < 0.01,
                            torch.where(ratio < b, ratio - 0.01,
                                        ratio + 0.01), ratio)
    logp_old = ppo._gauss_logp(mu, log_std, u) - torch.log(ratio)
    adv = torch.randn((rows,), generator=gen, device=dev)
    ret = torch.randn((rows,), generator=gen, device=dev)
    return (mu, log_std, value, u, logp_old, adv, ret, 0.2, 0.5, 0.01)


def check_ppo_loss(args: tuple, tag: str) -> float:
    """``ppo_gauss_loss`` against its plain version on the same card
    tensors: each output's largest |d| over its scale (``LOSS_GATE``; the
    scales from the per-row terms in float64), ``d_mu`` and ``d_value``
    the parts of one gradient of the head product, two calls bit-equal.
    Returns the largest |d| over the outputs."""
    import math

    import torch
    from sustaingym_tpu_torch.ops.cuda import ppo_loss as KL
    got = KL.ppo_gauss_loss(*args)
    again = KL.ppo_gauss_loss(*args)
    want = KL.ppo_gauss_loss_ref(*args)
    mu, log_std, value, u, logp_old, adv, ret, eps, vf_coef, ent_coef = args
    ls = log_std.double()
    logp = torch.sum(-0.5 * ((u - mu).double() ** 2 / torch.exp(2 * ls)
                             + 2 * ls + math.log(2 * math.pi)), -1)
    ratio = torch.exp(logp - logp_old.double())
    a = adv.double()
    a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
    pg_s = float(torch.minimum(ratio * a, torch.clamp(
        ratio, 1 - eps, 1 + eps) * a).abs().mean())
    vf_s = float((0.5 * (value.double() - ret.double()) ** 2).mean())
    ent_s = float((ls + 0.5 * math.log(2 * math.pi * math.e)).abs().sum())
    scale = {"loss": pg_s + vf_coef * vf_s + ent_coef * ent_s, "pg": pg_s,
             "vf": vf_s, "ent": ent_s}
    names = ("loss", "pg", "vf", "ent", "d_mu", "d_value", "d_log_std")
    gap, err = {}, 0.0
    for name, g, w in zip(names, got, want):
        diff = float((g.double() - w.double()).abs().max())
        err = max(err, diff)
        gap[name] = diff / scale.get(name, float(w.double().abs().max()))
    whole = got[4]._base is not None and got[4]._base is got[5]._base
    equal = all(torch.equal(x, y) for x, y in zip(got, again))
    rows, A = mu.shape
    shown = {k: float(f"{v:.3e}") for k, v in gap.items()}
    print(f"ppo_gauss_loss vs plain {rows}x{A} (mu strides {mu.stride()}): "
          f"|d| over scale {json.dumps(shown)}, max |d| {err:.3e}; "
          f"the head product's gradient whole {whole}; two calls bit-equal "
          f"{equal} (gate {LOSS_GATE}) {tag}", flush=True)
    if max(gap.values()) > LOSS_GATE or not whole or not equal:
        fail(f"ppo_gauss_loss differs from its plain version: {gap}, "
             f"gradient whole {whole}, bit-equal {equal}")
    return err


def trunk_inputs(rows: int, H: int, D: int, gen) -> tuple:
    """The trunk passes' operands at ``rows`` x ``H`` on the card: a GEMM
    output ``a`` and bias for the forward; for the backward a product
    ``p`` over three decades of magnitude, a saved activation ``y`` in
    (-1, 1) and a bf16 obs block ``x`` (rows, D) to copy."""
    import torch
    dev = gen.device
    a = 2.0 * torch.randn((rows, H), generator=gen, device=dev)
    bias = torch.randn((H,), generator=gen, device=dev)
    p = torch.randn((rows, H), generator=gen, device=dev) * torch.exp(
        3.0 * torch.randn((rows, H), generator=gen, device=dev))
    y = torch.tanh(2.0 * torch.randn((rows, H), generator=gen, device=dev))
    x = torch.randn((rows, D), generator=gen, device=dev).bfloat16()
    return a, bias, p, y, x


def check_ppo_trunk(args: tuple, tag: str) -> float:
    """``ppo_trunk``'s passes against their plain versions on the same
    card tensors: the forward pass with and without the kept ``y`` (y and
    h bit-equal), the backward pass with the obs copy (d, hf and the copy
    bit-equal, the bias sums within ``TRUNK_GATE`` of each column's sum
    of |d|), two calls bit-equal. Returns the bias sums' largest |d|."""
    import torch
    from sustaingym_tpu_torch.ops.cuda import ppo_trunk as KT
    a, bias, p, y, x = args
    equal, same = {}, True
    for keep in (True, False):
        got = KT.trunk_forward(a.clone(), bias, keep)
        again = KT.trunk_forward(a.clone(), bias, keep)
        want = KT.trunk_forward_ref(a.clone(), bias, keep)
        equal["h" if keep else "h (no y)"] = torch.equal(got[1], want[1])
        if keep:
            equal["y"] = torch.equal(got[0], want[0])
        else:
            equal["no y"] = got[0] is None
        same = same and all(u is v or torch.equal(u, v)
                            for u, v in zip(got, again))
    got = KT.trunk_backward(p.clone(), y.clone(), x)
    again = KT.trunk_backward(p.clone(), y.clone(), x)
    want = KT.trunk_backward_ref(p.clone(), y.clone(), x)
    for i, name in ((0, "d"), (2, "hf"), (3, "x copy")):
        equal[name] = torch.equal(got[i], want[i])
    same = same and all(torch.equal(u, v) for u, v in zip(got, again))
    gap = (got[1] - want[1]).abs()
    rel = float((gap / want[0].abs().sum(0)).max())
    err = float(gap.max())
    rows, H = p.shape
    print(f"ppo_trunk vs plain {rows}x{H} (obs copy {tuple(x.shape)}): "
          f"bit-equal {json.dumps(equal)}; bias sums max |d| {err:.3e}, "
          f"over the column's sum of |d| {rel:.3e} (gate {TRUNK_GATE}); "
          f"two calls bit-equal {same} {tag}", flush=True)
    if not all(equal.values()) or rel > TRUNK_GATE or not same:
        fail(f"ppo_trunk differs from its plain version: {equal}, bias "
             f"sums {rel:.3e}, bit-equal {same}")
    return err


# a minibatch's trunk passes: two forward passes that keep y, the second
# layer's backward pass and the first layer's with the obs copy
TRUNK_MINIBATCH = {"forward_keep": 2, "backward": 1, "backward_obs": 1}


def trunk_times(args: tuple) -> dict:
    """Each trunk pass at ``args``' shapes (``trunk_inputs``): its device
    time (``device_ms`` of its C entry point), its plain version's (CUDA
    events) and its bytes' least time (each operand read once, each
    output written once), and the forward pass without y (the
    scoring's)."""
    from sustaingym_tpu_torch.ops.cuda import ppo_trunk as KT
    a, bias, p, y, x = args
    f32, bf = nbytes(a), nbytes(a) // 2
    cases = {
        "forward_keep": (lambda: KT.trunk_forward(a, bias, True),
                         lambda: KT.trunk_forward_ref(a, bias, True),
                         "ppo_trunk_forward_launch", 2 * f32 + bf),
        "forward": (lambda: KT.trunk_forward(a, bias, False),
                    lambda: KT.trunk_forward_ref(a, bias, False),
                    "ppo_trunk_forward_launch", f32 + bf),
        "backward": (lambda: KT.trunk_backward(p, y),
                     lambda: KT.trunk_backward_ref(p, y),
                     "ppo_trunk_backward_launch", 4 * f32),
        "backward_obs": (lambda: KT.trunk_backward(p, y, x),
                         lambda: KT.trunk_backward_ref(p, y, x),
                         "ppo_trunk_backward_launch",
                         4 * f32 + 3 * nbytes(x))}
    return {name: {"ms": device_ms(kernel, launch, 50),
                   "plain_ms": cuda_ms(plain, 20),
                   "bound_ms": bound(n_bytes)[0]}
            for name, (kernel, plain, launch, n_bytes) in cases.items()}


def run_trainer(label: str, env, p, cfg, cfg0, seed: int, tag: str,
                steps: int = 2):
    """``steps`` captured PPO train steps at ``cfg`` (host clock,
    synchronised around each; the first holds the graphs' warm-ups and
    captures, printed apart; a multi-agent view's trainer also in
    agent-steps/s), the trainer's peak device memory, then the
    lr=0 exact-ratio check at ``cfg0`` through the captured path
    (|pg_loss| < 1e-5), each trainer freed before the next is made."""
    import torch
    from sustaingym_tpu_torch.parallel import make_train_step
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    init_state, train_step = make_train_step(env, p, cfg)
    tgen = torch.Generator(device=p.device).manual_seed(seed)
    carry = init_state(tgen)
    env_steps = cfg.num_envs * train_step.rollout_len
    agents = train_step.n_agents
    graphs = train_step.graphs
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, tgen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        m = {key: float(v) for key, v in metrics.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{label} train step {i}: non-finite metrics {m}")
        held = (f" (of which {graphs.captures} graphs' warm-up "
                f"{graphs.warmup_s:.3f} s, capture + instantiate "
                f"{graphs.capture_s:.3f} s)" if i == 0 else "")
        per_agent = (f" = {env_steps * agents / dt:.0f} agent-steps/s "
                     f"({agents} agents)" if agents > 1 else "")
        print(f"{label} train step {i}: {dt:.3f} s{held} = "
              f"{env_steps / dt:.0f} env-steps/s{per_agent}; "
              f"{json.dumps(m)} {tag}", flush=True)
    train_step.check(carry)         # the generic rollout's reset guard
    print(f"{label} trainer: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {tag}",
          flush=True)
    # the trainer's graphs and pool go before the lr=0 trainer's come
    del init_state, train_step, carry, graphs
    free_cuda()
    init0, step0 = make_train_step(env, p, cfg0)
    _, m0 = step0(init0(tgen), tgen)
    pg0 = float(m0["pg_loss"])
    print(f"{label} lr=0 train step at {cfg0.num_envs} envs (captured): "
          f"pg_loss {pg0:.3e} {tag}", flush=True)
    if not abs(pg0) < 1e-5:
        fail(f"{label} lr=0 exact-ratio invariant broken: pg_loss {pg0}")
    del init0, step0
    free_cuda()


def check_captured(label: str, env, p, cfg, seed: int, tag: str,
                   steps: int = 1, batch: int = CHECK_BATCH):
    """``steps`` train steps captured against the same steps eager
    (``capture=False``) from the same initial carry and generator state,
    at ``batch`` envs with the main path's minibatch rows: the
    largest differences of the parameters and metrics, and whether the
    generators end in the same state. Gate: bit-equal parameters,
    metrics and generator state (CAPTURE_GATE)."""
    import dataclasses

    import torch
    from sustaingym_tpu_torch.parallel import make_train_step
    small = dataclasses.replace(
        cfg, num_envs=batch,
        minibatches=max(1, cfg.minibatches * batch // cfg.num_envs))
    runs = {}
    for capture in (True, False):
        free_cuda()
        init_state, step = make_train_step(env, p, small, capture=capture)
        gen = torch.Generator(device=p.device).manual_seed(seed)
        carry = init_state(gen)
        for _ in range(steps):
            carry, metrics = step(carry, gen)
        runs[capture] = ([w.detach().clone()
                          for w in carry["policy"].parameters()],
                         {k: float(v) for k, v in metrics.items()},
                         gen.get_state())
        del init_state, step, carry
    (pc, mc, gc), (pe, me, ge) = runs[True], runs[False]
    d_param = max(float((a - b).abs().max()) for a, b in zip(pc, pe))
    d_metric = {k: abs(mc[k] - me[k]) for k in mc}
    equal = (all(torch.equal(a, b) for a, b in zip(pc, pe)) and mc == me
             and torch.equal(gc, ge))
    print(f"{label} captured vs eager, {steps} train step(s) at "
          f"{batch} envs "
          f"({small.minibatches} minibatches x {small.epochs} epochs): "
          f"params max|d| {d_param:.3e}; metrics |d| {d_metric}; generator "
          f"states equal {torch.equal(gc, ge)}; bit-equal {equal} "
          f"({CAPTURE_GATE}) {tag}", flush=True)
    if not equal:
        fail(f"{label}: the captured train step differs from the eager one")
    free_cuda()


def finish_trainer(label: str, env, p, cfg, seed: int, tag: str,
                   want_profile: bool, steps: int = 1,
                   batch: int = CHECK_BATCH):
    """After a trainer's launches are read: its captured-vs-eager check
    over ``steps`` train steps at ``batch`` envs and, with ``--profile``,
    its place in ``profile_trainers``' queue."""
    check_captured(label, env, p, cfg, seed, tag, steps, batch)
    if want_profile:
        PROFILE_JOBS.append((label, env, p, cfg, seed))


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
    from sustaingym_tpu_torch.bench import SIM_TIERS
    from sustaingym_tpu_torch.ops.cuda import cogen_rollout as KB
    from sustaingym_tpu_torch.ops.cuda import exog_gather as KA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    env, p = make("cogen", device=dev)
    L, C = p.timesteps_per_day, p.ambients.shape[2]
    rows = p.ambients.shape[1]
    flat = p.ambients.reshape(-1, C)
    B, T = SIM_TIERS["cogen"], COGEN_STEPS

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
                          "episode_slice_gather_launch", 20)
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
    cfg, cfg0 = trainer_configs("cogen")
    run_trainer("cogen", env, p, cfg, cfg0, 34, tag)
    launches = {"episode_slice_gather": KA.episode_slice_gather.launches,
                "cogen_segment": KB.cogen_segment.launches}
    if min(launches.values()) == 0:
        fail(f"a kernel of the cogen main path never launched: {launches}")
    finish_trainer("cogen", env, p, cfg, 34, tag, want_profile)

    seg_ms = device_ms(lambda: KB.cogen_segment(p, days, prev, T, seed=35),
                       "cogen_segment_launch", 10)
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


DC_ROWS = ("a", "executed", "queue", "reward", "carbon_cost",
           "delay_penalty")


def check_dc(case: str, ko, ro, tag: str) -> float:
    """``dc_segment`` (6, T, B) rows against its plain version: bit for
    bit on every row. Returns max |d|."""
    import torch
    d = (ko - ro).abs().amax(dim=(1, 2)).tolist()
    print(f"dc_segment {case}: max|d| per row "
          f"{dict(zip(DC_ROWS, d))}; bit-equal {torch.equal(ko, ro)} {tag}",
          flush=True)
    if not torch.equal(ko, ro):
        fail(f"dc_segment {case}: differs from its plain version")
    return max(d)


def dc_slice(tag: str, want_profile: bool) -> tuple[list, int]:
    """Phases 11-12 (module docstring); returns the kernel's entry of the
    ``kernels`` line and the slice-gather launches of its main path."""
    import torch
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.bench import SIM_TIERS
    from sustaingym_tpu_torch.ops.cuda import dc_rollout as K8
    from sustaingym_tpu_torch.ops.cuda import exog_gather as KA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    env, p = make("datacenter", device=dev)
    B, T = SIM_TIERS["datacenter"], DC_STEPS

    # ---- 11. dc_segment vs plain, bit-equal ------------------------------
    months = torch.randint(p.n_months, (DC_CHECK,), generator=gen, device=dev)
    acts = torch.rand((T, DC_CHECK), generator=gen, device=dev) * 1.2 - 0.1
    seg_err = check_dc(f"{DC_CHECK}x{T} prescribed VCCs in [-0.1, 1.1)",
                       K8.dc_segment(p, months, T, actions=acts),
                       K8.dc_segment_ref(p, months, T, actions=acts), tag)
    months = torch.randint(p.n_months, (B,), generator=gen, device=dev)
    ko = K8.dc_segment(p, months, T, seed=42)
    a = ko[0].contiguous()
    seg_err = max(seg_err, check_dc(
        f"{B}x{T} in-kernel draws", ko,
        K8.dc_segment_ref(p, months, T, actions=a), tag))
    del ko
    a_mean, a_min, a_max = float(a.mean()), float(a.min()), float(a.max())
    print(f"dc draws: {a.numel()} VCCs mean {a_mean:.6f} min {a_min:.3e} max "
          f"{a_max:.6f} {tag}", flush=True)
    if not (abs(a_mean - 0.5) <= 0.005 and a_min >= 0.0 and a_max < 1.0):
        fail("dc in-kernel draws off")
    del a

    # ---- 12. the datacenter main path: counts from 0 ------------------------
    KA.episode_slice_gather.launches = 0
    K8.dc_segment.launches = 0
    sim_gen = torch.Generator(device=dev).manual_seed(43)
    roll = env.fused_rollout(p, B, T, generator=sim_gen)
    if roll.reward.shape != (T, B) or roll.obs.shape != (T, B, 27) \
            or not bool(torch.isfinite(roll.reward).all()):
        fail("datacenter simulation tier: bad rewards or obs")
    mean_reward = float(roll.reward.mean())
    del roll
    cfg, cfg0 = trainer_configs("datacenter")
    run_trainer("datacenter", env, p, cfg, cfg0, 44, tag)
    launches = {"episode_slice_gather": KA.episode_slice_gather.launches,
                "dc_segment": K8.dc_segment.launches}
    if min(launches.values()) == 0:
        fail(f"a kernel of the datacenter main path never launched: "
             f"{launches}")
    finish_trainer("datacenter", env, p, cfg, 44, tag, want_profile)

    seg_ms = device_ms(lambda: K8.dc_segment(p, months, T, seed=45),
                       "dc_segment_launch", 10)
    seg_call_ms = cuda_ms(lambda: K8.dc_segment(p, months, T, seed=45), 10)
    seg_plain_ms = cuda_ms(lambda: K8.dc_segment_ref(p, months, T, seed=45),
                           1)
    sim_ms = cuda_ms(lambda: env.fused_rollout(p, B, T, generator=sim_gen), 2)
    seg_bound = bound(4 * K8.OUT_ROWS * T * B + nbytes(p.table, months),
                      f32_ops=K8.OPS_PER_STEP * T * B)
    # the card's write rate on the same bytes: PyTorch's fill of a tensor
    # of the kernel's output shape (no host check between launches)
    rows = torch.empty((K8.OUT_ROWS, T, B), device=dev)
    fill_ms = cuda_ms(lambda: rows.fill_(1.0), 10)
    print(f"write-rate yardstick: fill_ of a {nbytes(rows) / 1e9:.3f} GB "
          f"float32 tensor {fill_ms:.4f} ms (CUDA events) = "
          f"{nbytes(rows) / fill_ms / 1e9:.3f} TB/s {tag}", flush=True)
    del rows
    steps = B * T
    print(f"datacenter simulation tier {B}x{T}: whole fused_rollout call "
          f"{sim_ms:.3f} ms = {steps / sim_ms * 1e3:.0f} env-steps/s; "
          f"dc_segment kernel {seg_ms:.4f} ms (device) = "
          f"{steps / seg_ms * 1e3:.0f} env-steps/s, wrapper call "
          f"{seg_call_ms:.4f} ms, bound {seg_bound[0]:.4f} ms "
          f"({seg_bound[1]}); plain {seg_plain_ms:.3f} ms = "
          f"{steps / seg_plain_ms * 1e3:.0f} env-steps/s; mean reward "
          f"{mean_reward:.6f}; launches {launches} {tag}", flush=True)
    return [
        {"name": "dc_segment", "route": "cuda",
         "source": "sustaingym_tpu_torch/ops/cuda/csrc/dc_rollout.cu",
         "replaces": "sustaingym_tpu/ops/pallas/dc_rollout.py:84",
         "launches": launches["dc_segment"], "max_abs_err": seg_err,
         "ms": seg_ms, "plain_ms": seg_plain_ms, "bound_ms": seg_bound[0],
         "bound_by": seg_bound[1], "library_ms": None},
    ], launches["episode_slice_gather"]


def solve_diffs(got, want, rtol=1e-4, atol=2e-3) -> dict:
    """For each of (x, y, zp, zm): the share of entries outside rtol / atol
    (the JAX package's bound for its kernel against its solver,
    ``tests/test_ops_pallas.py:512-517``), max |d| and max |d| over the
    largest |value| of ``want``."""
    out = {}
    for name, g, w in zip(("x", "y", "zp", "zm"), got, want):
        d = (g.double() - w.double()).abs()
        out[name] = (float((d > atol + rtol * w.abs()).double().mean()),
                     float(d.max()),
                     float(d.max()) / max(float(w.abs().max()), 1e-30))
    return out


def f64_operands(kops):
    """``kops`` with its operator's matrices and steps in float64: the
    plain version then sums the same bf16-rounded products in float64."""
    from sustaingym_tpu_torch.core import replace
    op = kops.op
    return replace(kops, op=replace(op, **{
        f: getattr(op, f).double()
        for f in ("A", "S", "G", "tau", "sigma_a", "sigma_s", "sigma_g")}))


def check_solve(case: str, kops, args, iters, tag: str) -> float:
    """``pdhg_solve_paired`` against its plain version. A float32 sum in
    another order can flip the bf16 rounding of an iterate, which the
    following iterations carry on, so some entries of a large batch leave
    any elementwise bound. The yardstick is the same solve's sensitivity to
    its sums: the plain version in float32 against the plain version
    summing in float64. The gate, for each output: the share of entries
    outside rtol 1e-4 / atol 2e-3 and max |d| over the output's largest
    |value| each at most 1% or twice the yardstick's. ``iters``: an int,
    or (B,) int32 per-env budgets. Returns max |d|."""
    from sustaingym_tpu_torch.ops.cuda import lp_solve as K9
    got = K9.pdhg_solve_paired(kops, *args, iters)
    plain = K9.pdhg_solve_paired_ref(kops, *args, iters)
    wide = K9.pdhg_solve_paired_ref(f64_operands(kops),
                                    *(a.double() for a in args), iters)
    diffs, yard = solve_diffs(got, plain), solve_diffs(plain, wide)
    what = (f"{iters} iterations" if isinstance(iters, int)
            else "per-env budgets")
    print(f"pdhg_solve_paired {case} {what}: kernel vs plain "
          f"(share outside, max|d|, max|d| / max|plain|) {diffs}; plain "
          f"float32 vs float64 sums {yard} {tag}", flush=True)
    if not all(share <= max(0.01, 2 * yard[k][0])
               and rel <= max(0.01, 2 * yard[k][2])
               for k, (share, _, rel) in diffs.items()):
        fail(f"pdhg_solve_paired {case}: kernel off its plain version")
    return max(mx for _, mx, _ in diffs.values())


@contextlib.contextmanager
def plain_solves(float64: bool = False):
    """Context in which the market's lockstep solves run the kernel's plain
    version, summing in float32 or, with ``float64``, in float64 (results
    rounded back to float32): the kernel's yardstick inside
    ``batch_unroll``, and the trajectory's own sensitivity to its sums."""
    from sustaingym_tpu_torch.ops.cuda import lp_solve as K9

    def wide(kops, *args):
        *arrays, iters = args
        return tuple(o.float() for o in K9.pdhg_solve_paired_ref(
            f64_operands(kops), *(a.double() for a in arrays), iters))

    kernel = K9.pdhg_solve_paired
    K9.pdhg_solve_paired = wide if float64 else K9.pdhg_solve_paired_ref
    try:
        yield
    finally:
        K9.pdhg_solve_paired = kernel


def market_slice(tag: str, want_profile: bool) -> list:
    """Phases 13-14 (module docstring); returns the kernel's entry of the
    ``kernels`` line."""
    import torch
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.bench import SIM_TIERS, TRAINERS
    from sustaingym_tpu_torch.core import (batch_rollout, random_policy,
                                           tree_map)
    from sustaingym_tpu_torch.core.graph import Graphs, tree_leaves
    from sustaingym_tpu_torch.envs.electricitymarket import uses_solve_kernel
    from sustaingym_tpu_torch.envs.electricitymarket.env import MAX_BID
    from sustaingym_tpu_torch.ops.cuda import lp_solve as K9

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(51)
    env, p = make("electricitymarket", device=dev)
    if not uses_solve_kernel(p):
        fail("the card's default market does not solve through the kernel")
    op, B, T = p.op, SIM_TIERS["electricitymarket"], MKT_STEPS
    n, me, ms = op.n, op.me, op.ms
    kops = K9.pack_pdhg_operands(op)

    # ---- 13. pdhg_solve_paired vs plain ------------------------------------
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    h = rng.uniform(10, 500, (B, 2 * ms))
    z0 = np.abs(rng.normal(0, 1, (B, 2 * ms)))
    drawn = (t(rng.uniform(-50, 50, (B, n))), t(rng.uniform(100, 2000, (B, me))),
             t(h[:, :ms]), t(h[:, ms:]), p.ub, t(rng.uniform(0, 1, (B, n))),
             t(rng.normal(0, 5, (B, me))), t(z0[:, :ms]), t(z0[:, ms:]))
    solve_err = check_solve(f"drawn problems B={B}", kops, drawn, 50, tag)

    # the market's own problems: reset envs, bids over the action box
    state, _ = env.reset(p, gen, B)
    bids = torch.rand((B, 2 * p.horizon), generator=gen, device=dev) * MAX_BID
    c, b, hh, init, _ = env._sced_problem(p, state, bids)
    market = (c, b, hh[:, :ms].contiguous(), hh[:, ms:].contiguous(), p.ub,
              init.x, init.y, init.z[:, :ms].contiguous(),
              init.z[:, ms:].contiguous())

    def cleared(sol):
        x, y = sol[0].double(), sol[1].double()
        return {"price": y[:, 0], "charge": x[:, p.ic],
                "discharge": x[:, p.id]}

    for iters in (op.iters, p.lp_warm_iters):
        solve_err = max(solve_err, check_solve(
            f"market problems B={B}, cold start,", kops, market, iters, tag))
        got = cleared(K9.pdhg_solve_paired(kops, *market, iters))
        plain = cleared(K9.pdhg_solve_paired_ref(kops, *market, iters))
        wide = cleared(K9.pdhg_solve_paired_ref(
            f64_operands(kops), *(a.double() for a in market), iters))
        stats = {k: (q((got[k] - plain[k]).abs(), 0.99),
                     float((got[k] - plain[k]).abs().max())) for k in got}
        yard = {k: (q((plain[k] - wide[k]).abs(), 0.99),
                    float((plain[k] - wide[k]).abs().max())) for k in got}
        print(f"pdhg_solve_paired market problems B={B} {iters} iterations: "
              f"price and battery dispatch (q99, max) |d| kernel vs plain "
              f"{stats}; plain float32 vs float64 sums {yard} {tag}",
              flush=True)
        if iters == op.iters and not all(q99 < 0.05 and mx < 2.0
                                         for q99, mx in stats.values()):
            fail("pdhg_solve_paired: cold-budget price or dispatch off")

    # batch_unroll with the kernel against its plain version, same bids
    days = torch.randint(p.n_days, (2, B), generator=gen, device=dev)
    bid_rows = torch.rand((T, B, 2 * p.horizon), generator=gen,
                          device=dev) * MAX_BID

    def replay():
        rows = iter(bid_rows)
        return lambda _, obs, g: next(rows)

    kroll = env.batch_unroll(p, replay(), None, B, T, days=days)
    with plain_solves():
        rroll = env.batch_unroll(p, replay(), None, B, T, days=days)
    with plain_solves(float64=True):
        wroll = env.batch_unroll(p, replay(), None, B, T, days=days)

    def price_diffs(a, b):
        d = (a.info["price"] - b.info["price"]).abs()
        return float(d.mean()), q(d, 0.99), float(d.max())

    dp, yard = price_diffs(kroll, rroll), price_diffs(rroll, wroll)
    print(f"market batch_unroll {B}x{T} on the same bids and days: clearing "
          f"price |d| (mean, q99, max) $/MWh kernel vs plain {dp}; plain "
          f"float32 vs float64 sums {yard} {tag}", flush=True)
    # a bf16 flip that changes one dispatch moves the battery's energy and
    # with it every later problem of that env: the max over 1.2 M prices
    # is held to the trajectory's own sensitivity, the mean to the bound
    if not (dp[0] < 0.25 and dp[1] < 2.0 and dp[2] <= max(2.0, 2 * yard[2])):
        fail("market batch_unroll: kernel prices off the plain version's")
    del kroll, rroll, wroll, bid_rows
    solve_err = max(solve_err, dp[2])

    # ---- 14. the market main path: counts from 0 ----------------------------
    # the simulation tier eager first, to hold the captured one against it
    policy = random_policy(env, p, B)
    eager_gen = torch.Generator(device=dev).manual_seed(52)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = env.batch_unroll(p, policy, None, B, T, eager_gen)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    K9.pdhg_solve_paired.launches = 0
    sim_gen = torch.Generator(device=dev).manual_seed(52)
    graphs = Graphs(dev)
    sim_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roll = batch_rollout(env, p, policy, None, sim_gen, B, T,
                             graphs=graphs)
        torch.cuda.synchronize()
        sim_s.append(time.perf_counter() - t0)
        if len(sim_s) == 1:
            first_launches = K9.pdhg_solve_paired.launches
            first = tree_map(torch.clone, roll)
    replay_launches = K9.pdhg_solve_paired.launches - first_launches
    if roll.reward.shape != (T, B) \
            or not bool(torch.isfinite(roll.reward).all()):
        fail("market simulation tier: bad rewards")
    sim_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                      tree_leaves(eager)))
    print(f"market simulation tier {B}x{T} through the captured episode "
          f"loop: bit-equal to the eager batch_unroll from the same "
          f"generator state {sim_equal}; first call {sim_s[0] * 1e3:.1f} ms "
          f"(warm-up {graphs.warmup_s * 1e3:.1f} ms, capture + instantiate "
          f"{graphs.capture_s * 1e3:.1f} ms), second call (one replay) "
          f"{sim_s[1] * 1e3:.1f} ms, eager {eager_s * 1e3:.1f} ms; "
          f"pdhg_solve_paired launches {first_launches} at the first call "
          f"(warm-up and one replay), {replay_launches} at the second (one "
          f"replay) {tag}", flush=True)
    if not sim_equal:
        fail("market simulation tier: the captured loop differs from eager")
    if first_launches != 2 * T or replay_launches != T:
        fail(f"pdhg_solve_paired launches: {first_launches} at the warm-up "
             f"and first replay of a {T}-step episode, {replay_launches} at "
             f"a replay")
    mean_reward = float(roll.reward.mean())
    del roll, first, eager, graphs
    free_cuda()
    cfg, cfg0 = trainer_configs("market")
    dcfg, dcfg0 = trainer_configs("market discrete")
    run_trainer("market", env, p, cfg, cfg0, 53, tag)
    denv, dparams = make("electricitymarket", device=dev,
                         **TRAINERS["market discrete"][2])
    run_trainer("market discrete", denv, dparams, dcfg, dcfg0, 54, tag)
    launches = K9.pdhg_solve_paired.launches
    if launches == 0:
        fail("pdhg_solve_paired never launched on the market main path")
    finish_trainer("market", env, p, cfg, 53, tag, want_profile)
    finish_trainer("market discrete", denv, dparams, dcfg, 54, tag,
                   want_profile)

    warm, cold = p.lp_warm_iters, op.iters
    # device time by CUDA events over back-to-back launches: the wrapper
    # never waits on the host, so the card runs them without gaps (late in
    # this long process the profiler's trace lost some of these launches)
    warm_ms = cuda_ms(lambda: K9.pdhg_solve_paired(kops, *market, warm), 10)
    cold_ms = cuda_ms(lambda: K9.pdhg_solve_paired(kops, *market, cold), 3)
    plain_ms = cuda_ms(lambda: K9.pdhg_solve_paired_ref(kops, *market, warm),
                       3)
    io_bytes = (nbytes(*market, kops.K, kops.tau, kops.sig)
                + 4 * B * (n + me + 2 * ms))

    def solve_bound(iters, peak_type):
        return bound(io_bytes, **{peak_type: 4 * n * (me + ms) * iters * B})

    warm_bound, cold_bound = (solve_bound(warm, "bf16_ops"),
                              solve_bound(cold, "bf16_ops"))
    xbar = torch.randn((n, B), generator=gen, device=dev).bfloat16()
    wpan = torch.randn((me + ms, B), generator=gen, device=dev).bfloat16()

    def solve_products():
        for _ in range(warm):
            torch.matmul(kops.K, xbar)
            torch.matmul(kops.K.t(), wpan)

    products_ms = cuda_ms(solve_products, 3)
    ctas, envs = K9.pdhg_occupancy(op)
    print(f"pdhg_solve_paired B={B}: warm solve ({warm} iterations) "
          f"{warm_ms:.4f} ms (CUDA events, back-to-back launches), bound "
          f"{warm_bound[0]:.4f} ms ({warm_bound[1]}, bf16 peak; "
          f"{solve_bound(warm, 'f32_ops')[0]:.4f} ms at the f32 peak); cold "
          f"solve ({cold} iterations) {cold_ms:.4f} ms, bound "
          f"{cold_bound[0]:.4f} ms; plain warm solve {plain_ms:.3f} ms; "
          f"launches {launches} on the main path (one a step of each "
          f"episode replayed, and of each graph's warm-up); {ctas} CTA(s) "
          f"of {envs} envs resident per SM {tag}",
          flush=True)
    print(f"yardstick, not called by the port: a warm solve's products as "
          f"{2 * warm} bf16 torch.matmul calls (K x-bar, K' w at B = {B}) "
          f"{products_ms:.4f} ms (CUDA events) {tag}", flush=True)
    steps = B * T
    print(f"market simulation tier {B}x{T}: whole batch_rollout (one "
          f"replay) {sim_s[1] * 1e3:.1f} ms = {steps / sim_s[1]:.0f} "
          f"env-steps/s, of which the kernel ~"
          f"{cold_ms + (T - 1) * warm_ms:.1f} ms; mean reward "
          f"{mean_reward:.6f} {tag}", flush=True)
    return [
        {"name": "pdhg_solve_paired", "route": "cuda",
         "source": "sustaingym_tpu_torch/ops/cuda/csrc/lp_solve.cu",
         "replaces": "sustaingym_tpu/ops/pallas/lp_solve.py:110",
         "launches": launches, "max_abs_err": solve_err, "ms": warm_ms,
         "plain_ms": plain_ms, "bound_ms": warm_bound[0],
         "bound_by": warm_bound[1], "library_ms": None},
    ]


# phase 35: batch and numpy seed of its market problems
MIXED_BATCH, MIXED_SEED = 4096, 35
# SHA-256 of pdhg_solve_paired's outputs with one int budget (cold, then
# warm) on phase 35's problems, from the kernel before per-env budgets
# (lp_solve.cu of commit 4cab02f) on an NVIDIA H100 80GB HBM3. It holds
# only while the problems stay the same: a change to the market's problem
# assembly (``_sced_problem``, ``make_params``' defaults, the packing of
# ``pack_pdhg_operands``), to ``market_problems`` or to the toolchain
# invalidates it, with the kernel unchanged. To regenerate it, unpack
# that commit into a git-ignored directory (``git archive 4cab02f``) and
# run ``python3 tools/kernel_times.py --root DIR`` on the card with this
# checkout's tools/ (it prints ``pdhg_int_digest``)
PARENT_PDHG_INT_DIGEST = (
    "50bb0e07e6525017131f8e8e71947f7953ed8a6767274001d1ec7fe2ae61bdeb")


def market_problems(env, p, batch: int, seed: int):
    """``batch`` SCED problems of the market's first step, in
    ``pdhg_solve_paired``'s operand order: days and bids (uniform over the
    action box) drawn with numpy from ``seed``."""
    import torch
    from sustaingym_tpu_torch.envs.electricitymarket.env import MAX_BID
    rng = np.random.default_rng(seed)
    days = torch.as_tensor(rng.integers(0, p.n_days, batch),
                           device=p.device)
    bids = torch.as_tensor(rng.uniform(0, MAX_BID, (batch, 2 * p.horizon)),
                           dtype=torch.float32, device=p.device)
    state, _ = env.reset_at_day(p, days)
    c, b, h, init, _ = env._sced_problem(p, state, bids)
    ms = p.op.ms
    return (c, b, h[:, :ms].contiguous(), h[:, ms:].contiguous(), p.ub,
            init.x, init.y, init.z[:, :ms].contiguous(),
            init.z[:, ms:].contiguous())


def pdhg_int_digest(env, p, K9) -> str:
    """SHA-256 of ``pdhg_solve_paired``'s (x, y, zp, zm) with one int
    budget, the cold one then the warm one, on phase 35's problems. Calls
    only what every version of the wrapper has, so it reads the kernel of
    any checkout (``tools/kernel_times.py --root``)."""
    kops = K9.pack_pdhg_operands(p.op)
    market = market_problems(env, p, MIXED_BATCH, MIXED_SEED)
    digest = hashlib.sha256()
    for iters in (p.op.iters, p.lp_warm_iters):
        for x in K9.pdhg_solve_paired(kops, *market, iters):
            digest.update(x.cpu().numpy().tobytes())
    return digest.hexdigest()


def mixed_budgets(tag: str) -> float:
    """Phase 35: ``pdhg_solve_paired`` with per-env budgets, the cold and
    the warm one mixed in one batch, on the market's own problems at B =
    4096: against its plain version (``check_solve``'s gates); each env
    bit-equal to a launch with one int budget, its own; the int launches'
    outputs bit-equal to the parent kernel's (``PARENT_PDHG_INT_DIGEST``);
    times of the mixed launch and of the uniform ones (CUDA events).
    Returns the largest difference from the plain version."""
    import torch
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.ops.cuda import lp_solve as K9
    env, p = make("electricitymarket", device=torch.device("cuda"))
    cold, warm, B = p.op.iters, p.lp_warm_iters, MIXED_BATCH
    market = market_problems(env, p, B, MIXED_SEED)
    rng = np.random.default_rng(MIXED_SEED + 1)
    budget = torch.as_tensor(rng.choice([cold, warm], B), dtype=torch.int32,
                             device=p.device)
    err = check_solve(f"market problems B={B}, cold {cold} and warm {warm} "
                      f"mixed,", p.kops, market, budget, tag)
    got = K9.pdhg_solve_paired(p.kops, *market, budget)
    equal = {}
    for k in (cold, warm):
        rows = budget == k
        uniform = K9.pdhg_solve_paired(p.kops, *market, k)
        equal[k] = all(torch.equal(g[rows], u[rows])
                       for g, u in zip(got, uniform))
    digest = pdhg_int_digest(env, p, K9)
    mixed_ms = cuda_ms(lambda: K9.pdhg_solve_paired(p.kops, *market, budget),
                       5)
    cold_ms = cuda_ms(lambda: K9.pdhg_solve_paired(p.kops, *market, cold), 5)
    warm_ms = cuda_ms(lambda: K9.pdhg_solve_paired(p.kops, *market, warm), 5)
    share = float((budget == cold).double().mean())
    print(f"pdhg_solve_paired mixed budgets B={B} ({share:.1%} cold): each "
          f"env bit-equal to a uniform launch at its own budget {equal}; "
          f"int launches' digest {digest}, the parent kernel's "
          f"{PARENT_PDHG_INT_DIGEST}: bit-equal "
          f"{digest == PARENT_PDHG_INT_DIGEST}; mixed launch {mixed_ms:.4f} "
          f"ms, uniform cold {cold_ms:.4f} ms, uniform warm {warm_ms:.4f} ms "
          f"(CUDA events) {tag}", flush=True)
    if not all(equal.values()):
        fail("pdhg_solve_paired: an env with its own budget differs from "
             "the uniform launch at that budget")
    if digest != PARENT_PDHG_INT_DIGEST:
        fail("pdhg_solve_paired: the int budget's outputs differ from the "
             "parent kernel's")
    return err


def baselines_on_card(tag: str):
    """Phase 36: the EV baselines' batched paths on the card against the
    same runs on the CPU: ``offline_optimal_schedule`` of the busiest day
    (3000 PDHG iterations; |d| <= 2e-3 on pilots in [0, 1], the bound of
    its JAX comparison), and ``batch_returns``, the lockstep loop of
    ``batch_run``, with the greedy policy over 64 seeds x 288 steps (each
    return within rtol 2e-4 / atol 2e-3: the EV step's parity bound,
    float32 sums in another order, over an episode)."""
    import torch
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.algorithms import batch_returns
    from sustaingym_tpu_torch.algorithms.evcharging import (
        offline_optimal_schedule)

    def greedy(obs, generator):
        return (obs["demands"] > 0).to(torch.float32)

    runs = {}
    for dev in ("cuda", "cpu"):
        env, p = make("evcharging", device=dev)
        day = int(torch.argmax(p.day_num_evs))
        t0 = time.perf_counter()
        sched = offline_optimal_schedule(p, day).cpu()
        t1 = time.perf_counter()
        rets = batch_returns(env, p, greedy, range(64), STEPS).cpu()
        t2 = time.perf_counter()
        runs[dev] = sched, rets, t1 - t0, t2 - t1
    (sc, rc, sc_s, rc_s), (sh, rh, sh_s, rh_s) = runs["cuda"], runs["cpu"]
    d_sched = float((sc - sh).abs().max())
    d_ret = (rc.double() - rh.double()).abs()
    ok_ret = bool((d_ret <= 2e-3 + 2e-4 * rh.double().abs()).all())
    lo, hi = float(sc.min()), float(sc.max())
    print(f"offline_optimal_schedule day {day}: card {sc_s:.3f} s, CPU "
          f"{sh_s:.3f} s, max |d| {d_sched:.3e} (pilots in [{lo:.3f}, "
          f"{hi:.3f}]); batch_run greedy 64 seeds x "
          f"{STEPS}: card {rc_s:.3f} s, CPU {rh_s:.3f} s, returns mean "
          f"{float(rc.mean()):.6f}, max |d| {float(d_ret.max()):.3e} {tag}",
          flush=True)
    if not (d_sched <= 2e-3 and lo >= 0 and hi <= 1 and ok_ret
            and bool(torch.isfinite(rc).all())):
        fail("the EV baselines on the card differ from their CPU runs")


BUILDING_FIELDS = ("obs", "zone_temperature", "reward", "comfort_level",
                   "power_consumption")


def check_building(case: str, ko: dict, ro: dict, tag: str) -> float:
    """``building_segment`` against its plain version: bit-equality is the
    target; the gate is max |d| <= 1e-5 on zone temperatures and rewards
    (and every field finite). Returns the largest |d| over the fields."""
    import torch
    d = {k: float((ko[k] - ro[k]).abs().max()) for k in BUILDING_FIELDS}
    equal = all(torch.equal(ko[k], ro[k]) for k in BUILDING_FIELDS)
    print(f"building_segment {case}: max|d| per field {d}; bit-equal "
          f"{equal} {tag}", flush=True)
    if not (d["zone_temperature"] <= 1e-5 and d["reward"] <= 1e-5
            and all(bool(torch.isfinite(ko[k]).all())
                    for k in BUILDING_FIELDS)):
        fail(f"building_segment {case}: off its plain version")
    return max(d.values())


def policy_drift(n: int, kernel, plain) -> str:
    """Where ``building_policy_segment``'s most drifting episode leaves its
    plain version: for the env with the largest |d reward|, the first step
    at which |d reward| passes 1e-3, and the first step at which any of its
    learner-block entries (the bf16 obs and the bf16 u) differ, with the
    entries and their values. A print, not a gate."""
    import torch
    (ko, kl), (ro, rl) = kernel, plain
    dr = (ko[..., 0] - ro[..., 0]).abs()
    b = int(dr.max(0).values.argmax())
    past = (dr[:, b] > 1e-3).nonzero()
    t_r = int(past[0]) if len(past) else None
    names = ([f"temp[{i}]" for i in range(n)]
             + ["out", "ground", "ghi", "occupower/1000"]
             + [f"u[{i}]" for i in range(n)])
    diff = kl[:, b] != rl[:, b]
    rows = diff.any(1).nonzero()
    if not len(rows):
        return (f"env {b}: |d reward| first > 1e-3 at step {t_r}; learner "
                f"block equal at every step")
    t_f = int(rows[0])
    cols = diff[t_f].nonzero().flatten().tolist()
    entries = ", ".join(f"{names[c]} {float(kl[t_f, b, c]):.6g} vs "
                        f"{float(rl[t_f, b, c]):.6g}" for c in cols)
    d_before = float(dr[:t_f + 1, b].max())
    return (f"env {b}: |d reward| first > 1e-3 at step {t_r}; learner block "
            f"first differs at step {t_f} in {entries} (kernel vs plain); "
            f"max |d reward| up to that step {d_before:.3e}; "
            f"{'a bf16 flip comes first' if t_r is None or t_f <= t_r else 'no flip comes first'}")


def check_building_policy(case: str, n: int, kernel, plain, tag: str
                          ) -> float:
    """``building_policy_segment`` against its plain version with the JAX
    package's bounds for its kernel (``tests/test_ops_pallas.py:461-478``):
    over the first 32 steps q99 |d| < 0.05 for zone temperatures and u and
    < 0.02 for the reward; over the episode |d| of the reward's mean
    < 5e-3 and of its std < 2e-2. Returns max |d reward|."""
    (ko, kl), (ro, rl) = kernel, plain
    kl, rl = kl.float(), rl.float()
    dx = q((kl[:32, :, :n] - rl[:32, :, :n]).abs(), 0.99)
    du = q((kl[:32, :, n + 4:] - rl[:32, :, n + 4:]).abs(), 0.99)
    dr = (ko[..., 0] - ro[..., 0]).abs()
    dr32 = q(dr[:32], 0.99)
    dmean = abs(float(ko[..., 0].mean() - ro[..., 0].mean()))
    dstd = abs(float(ko[..., 0].std() - ro[..., 0].std()))
    print(f"building_policy_segment {case}: first 32 steps q99 |d| temps "
          f"{dx:.3e} u {du:.3e} reward {dr32:.3e}; episode reward max|d| "
          f"{float(dr.max()):.3e}, |d mean| {dmean:.3e}, |d std| {dstd:.3e} "
          f"{tag}", flush=True)
    print(f"building_policy_segment {case} drift: "
          f"{policy_drift(n, kernel, plain)} {tag}", flush=True)
    if not (dx < 0.05 and du < 0.05 and dr32 < 0.02 and dmean < 5e-3
            and dstd < 2e-2):
        fail(f"building_policy_segment {case}: outside the JAX bounds")
    return float(dr.max())


def building_slice(tag: str, want_profile: bool) -> tuple[list, int]:
    """Phases 15-17 (module docstring); returns the two kernels' entries of
    the ``kernels`` line and the slice-gather launches of its main path."""
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch.bench import HIDDEN, SIM_TIERS, TRAINERS
    from sustaingym_tpu_torch.envs import building
    from sustaingym_tpu_torch.envs.building import synthetic
    from sustaingym_tpu_torch.ops.cuda import building_rollout as K5
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    from sustaingym_tpu_torch.ops.cuda import exog_gather as KA
    from sustaingym_tpu_torch.ops.cuda.wrap import bind, raise_on
    from sustaingym_tpu_torch.parallel import init_policy

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(61)
    tables = tempfile.mkdtemp(prefix="building_tables_")
    try:
        htm, epw = synthetic.write_building_tables(tables)
        env, p = building.make_env(
            htm, epw, "Tucson", device=dev, root=tables,
            u_wall=building.BUILDINGS["OfficeSmall"][1])
    finally:
        shutil.rmtree(tables)
    n, T, B = p.n, p.episode_len, SIM_TIERS["building"]
    train_envs = TRAINERS["building fused"][3]["num_envs"]
    print(f"building: {n} zones, operator {tuple(p.BD_d.shape)}, "
          f"{p.length_of_weather} weather rows {tag}", flush=True)

    # ---- 15. building_segment vs plain -----------------------------------
    epochs = torch.randint(p.length_of_weather - 1, (BLD_CHECK,),
                           generator=gen, device=dev)
    acts = (torch.rand((T, BLD_CHECK, n), generator=gen, device=dev) * 2
            - 1) * p.ac_map
    seg_err = check_building(
        f"{BLD_CHECK}x{T} prescribed actions in [-ac, ac)",
        K5.building_segment(p, epochs, T, actions=acts),
        K5.building_segment_ref(p, epochs, T, actions=acts), tag)
    epochs = torch.randint(p.length_of_weather - 1, (B,), generator=gen,
                           device=dev)
    ko = K5.building_segment(p, epochs, T, seed=62, record_actions=True)
    a = ko.pop("actions")
    seg_err = max(seg_err, check_building(
        f"{B}x{T} in-kernel draws", ko,
        K5.building_segment_ref(p, epochs, T, actions=a), tag))
    del ko
    r = a / p.ac_map
    r_mean, r_min, r_max = float(r.mean()), float(r.min()), float(r.max())
    print(f"building draws: {r.numel()} actions / ac mean {r_mean:.6f} min "
          f"{r_min:.6f} max {r_max:.6f} {tag}", flush=True)
    if not (abs(r_mean) <= 0.002 and r_min >= -1.0 and r_max < 1.0):
        fail("building in-kernel draws off")
    del a, r

    # ---- 16. building_policy_segment vs plain ------------------------------
    pol_err = 0.0
    for batch in (CHECK_BATCH, train_envs):
        w = K.pack_policy_weights(init_policy(
            n + 4, n, HIDDEN, torch.Generator().manual_seed(batch), dev))
        e = torch.randint(p.length_of_weather - 1, (batch,), generator=gen,
                          device=dev)
        noise = torch.randn((T, batch, n), generator=gen, device=dev)
        pol_err = max(pol_err, check_building_policy(
            f"{batch}x{T} H={HIDDEN}", n,
            K5.building_policy_segment(p, w, e, T, noise=noise),
            K5.building_policy_segment_ref(p, w, e, T, noise=noise), tag))
    del noise
    zero = init_policy(n + 4, n, HIDDEN, torch.Generator().manual_seed(63),
                       dev)
    with torch.no_grad():
        zero.mu.weight.zero_()
        zero.log_std.zero_()
    _, lrn = K5.building_policy_segment(
        p, K.pack_policy_weights(zero), e[:CHECK_BATCH], T, seed=64)
    z = lrn[..., n + 4:].float()                 # u = 0 + 1 * N(0, 1), bf16
    z_mean, z_var = float(z.mean()), float(z.var())
    print(f"building normal draws: {z.numel()} mean {z_mean:.6f} var "
          f"{z_var:.6f} {tag}", flush=True)
    if not (abs(z_mean) < 0.01 and abs(z_var - 1.0) < 0.01):
        fail("building normal draws off")
    del lrn, z

    # ---- 17. the building main path: counts from 0 -------------------------
    KA.episode_slice_gather.launches = 0
    K5.building_segment.launches = 0
    K5.building_policy_segment.launches = 0
    sim_gen = torch.Generator(device=dev).manual_seed(65)
    roll = env.fused_rollout(p, B, T, generator=sim_gen)
    if roll.reward.shape != (T, B) or roll.obs.shape != (T, B, n + 4) \
            or not bool(torch.isfinite(roll.reward).all()) \
            or not bool(roll.terminated[T - 1].all()) \
            or bool(roll.terminated[:T - 1].any()):
        fail("building simulation tier: bad rewards, obs or done")
    mean_reward = float(roll.reward.mean())
    del roll
    configs = {}
    for label, steps in (("building fused", 2), ("building episodic", 1)):
        configs[label], cfg0 = trainer_configs(label)
        run_trainer(label, env, p, configs[label], cfg0, 66, tag, steps)
    launches = {"episode_slice_gather": KA.episode_slice_gather.launches,
                "building_segment": K5.building_segment.launches,
                "building_policy_segment":
                    K5.building_policy_segment.launches}
    if min(launches.values()) == 0:
        fail(f"a kernel of the building main path never launched: "
             f"{launches}")
    for label, cfg in configs.items():
        finish_trainer(label, env, p, cfg, 66, tag, want_profile)

    # device time by CUDA events over back-to-back launches of the kernels'
    # C entry points into outputs allocated once: the wrappers' range
    # checks wait on the host, and the profiler's trace lost some of these
    # launches
    lib = bind("building_rollout", K5._SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = K5._operator(p)
    sim_out = K5._outputs(n, B, T, dev, False)
    seg_args = (K5._env_args(p, m, epochs, T, "building_segment")
                + [None, 67] + [sim_out[k].data_ptr() for k in BUILDING_FIELDS]
                + [None, stream])
    seg_ms = cuda_ms(lambda: raise_on(lib.building_segment_launch(*seg_args),
                                      "building_segment"), 5)
    del sim_out
    seg_plain_ms = cuda_ms(lambda: K5.building_segment_ref(p, epochs, T,
                                                           seed=67), 1)
    sim_ms = cuda_ms(lambda: env.fused_rollout(p, B, T, generator=sim_gen), 2)
    seg_bound = bound(4 * (2 * n + 7) * T * B + nbytes(p.exog, epochs),
                      f32_ops=K5.ops_per_step(n) * T * B)
    steps = B * T
    print(f"building simulation tier {B}x{T}: whole fused_rollout call "
          f"{sim_ms:.3f} ms = {steps / sim_ms * 1e3:.0f} env-steps/s; "
          f"building_segment kernel {seg_ms:.4f} ms (CUDA events) = "
          f"{steps / seg_ms * 1e3:.0f} env-steps/s, bound "
          f"{seg_bound[0]:.4f} ms ({seg_bound[1]}); plain {seg_plain_ms:.3f} "
          f"ms; mean reward {mean_reward:.6f}; launches {launches} {tag}",
          flush=True)
    w = K.pack_policy_weights(init_policy(
        n + 4, n, HIDDEN, torch.Generator().manual_seed(68), dev))
    e = epochs[:train_envs]
    pol_out = torch.empty((T, train_envs, 3), device=dev)
    pol_lrn = torch.empty((T, train_envs, 2 * n + 4), dtype=torch.bfloat16,
                          device=dev)
    pol_args = (K5._env_args(p, m, e, T, "building_policy_segment")
                + K.policy_weight_args(w)
                + [HIDDEN, None, 69, 0,       # seed 69, env_offset 0
                   pol_out.data_ptr(), pol_lrn.data_ptr(), stream])
    pol_ms = cuda_ms(lambda: raise_on(
        lib.building_policy_segment_launch(*pol_args),
        "building_policy_segment"), 3)
    del pol_out, pol_lrn
    pol_plain_ms = cuda_ms(lambda: K5.building_policy_segment_ref(
        p, w, e, T, seed=69), 1)
    D = n + 4
    plan = K5.building_policy_plan(n, HIDDEN)
    ctas = plan["ctas"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = -(-train_envs // (16 * plan["tiles"]))
    print(f"building_policy_segment H={HIDDEN}: plan {plan}; {ctas} CTA(s) "
          f"of {16 * plan['tiles']} envs resident per SM, {grid} CTAs = "
          f"{grid / (ctas * sms):.3f} waves on {sms} SMs {tag}", flush=True)
    obs = torch.randn((train_envs, D), generator=gen, device=dev).bfloat16()
    hid = torch.randn((train_envs, HIDDEN), generator=gen,
                      device=dev).bfloat16()

    def actor_matmuls():
        for _ in range(T):
            torch.matmul(obs, w.w1)
            torch.matmul(hid, w.w2)
            torch.matmul(hid, w.wm)

    print(f"yardstick, not called by the port: the building actor's three "
          f"bf16 torch.matmul per step at {train_envs} rows x {T} steps "
          f"{cuda_ms(actor_matmuls, 2):.3f} ms (CUDA events) {tag}",
          flush=True)
    del obs, hid
    pol_flops = train_envs * T * 2 * (D * HIDDEN + HIDDEN * HIDDEN
                                      + HIDDEN * n)
    pol_bound = bound(
        nbytes(p.exog, e) + actor_bytes(w)
        + train_envs * T * (4 * 3 + 2 * (2 * n + 4)),
        f32_ops=train_envs * T * K5.ops_per_step(n), bf16_ops=pol_flops)
    print(f"building_policy_segment {train_envs}x{T} H={HIDDEN}: kernel "
          f"{pol_ms:.3f} ms (CUDA events) = {pol_flops / pol_ms / 1e9:.3f} "
          f"TFLOP/s in the actor, bound {pol_bound[0]:.4f} ms "
          f"({pol_bound[1]}, the actor at the bf16 peak; "
          f"{pol_flops / PEAK_F32 * 1e3:.3f} ms at the f32 peak); plain "
          f"{pol_plain_ms:.3f} ms {tag}", flush=True)
    src = "sustaingym_tpu_torch/ops/cuda/csrc/building_rollout.cu"
    return [
        {"name": "building_segment", "route": "cuda", "source": src,
         "replaces": "sustaingym_tpu/ops/pallas/building_rollout.py:143",
         "launches": launches["building_segment"], "max_abs_err": seg_err,
         "ms": seg_ms, "plain_ms": seg_plain_ms, "bound_ms": seg_bound[0],
         "bound_by": seg_bound[1], "library_ms": None},
        {"name": "building_policy_segment", "route": "cuda", "source": src,
         "replaces": "sustaingym_tpu/ops/pallas/building_rollout.py:348",
         "launches": launches["building_policy_segment"],
         "max_abs_err": pol_err, "ms": pol_ms, "plain_ms": pol_plain_ms,
         "bound_ms": pol_bound[0], "bound_by": pol_bound[1],
         "library_ms": None},
    ], launches["episode_slice_gather"]


def ev_lockstep_slice(tag: str, want_profile: bool) -> dict:
    """Phases 18-22 (module docstring); returns the ADMM kernel's entry of
    the ``kernels`` line."""
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch import make, train
    from sustaingym_tpu_torch.bench import HIDDEN, SIM_TIERS
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    from sustaingym_tpu_torch.parallel import init_policy

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(18)
    sim_batch = SIM_TIERS["evcharging"]
    B, T = CHECK_BATCH, STEPS

    # ---- 18. ev_segment's ADMM branch vs its plain version -------------
    err = 0.0
    for site in ("caltech", "jpl"):
        _, p = make("evcharging", site=site, proj_method="admm", device=dev)
        days = torch.randint(p.n_days, (B,), generator=gen, device=dev)
        acts = torch.rand((T, B, p.n_stations), generator=gen, device=dev)
        err = max(err, check_segment(
            f"ADMM {site} projection=on {B}x{T}",
            K.ev_segment(p, days, T, actions=acts)[0],
            K.ev_segment_ref(p, days, T, actions=acts)[0], tag))
    env, p = make("evcharging", proj_method="admm", device=dev)
    _, p_dual = make("evcharging", device=dev)
    n, m2, iters = p.n_stations, int(p.proj.C.shape[0]), int(p.proj.iters)
    days = torch.randint(p.n_days, (sim_batch,), generator=gen, device=dev)
    ko, acts = K.ev_segment(p, days, T, seed=19, record_actions=True)
    ro, _ = K.ev_segment_ref(p, days, T, actions=acts)
    err = max(err, check_segment(
        f"ADMM caltech projection=on {sim_batch}x{T} in-kernel draws", ko, ro,
        tag))
    del ko, ro, acts

    # the ADMM simulation tier, its count from 0
    K.ev_segment.launches = 0
    roll = env.fused_rollout(p, sim_batch, T,
                             generator=torch.Generator(device=dev)
                             .manual_seed(20))
    admm_launches = K.ev_segment.launches
    if roll.reward.shape != (T, sim_batch) \
            or not bool(torch.isfinite(roll.reward).all()) \
            or admm_launches == 0:
        fail(f"ADMM simulation tier: bad rewards or {admm_launches} "
             f"launches")
    admm_reward = float(roll.reward.mean())
    del roll

    admm_ms = device_ms(lambda: K.ev_segment(p, days, T, seed=21),
                        "ev_segment_launch", 3)
    dual_ms = device_ms(lambda: K.ev_segment(p_dual, days, T, seed=21),
                        "ev_segment_launch", 3)
    run = torch.zeros((), dtype=torch.long, device=dev)
    K.ev_segment(p, days, T, seed=21, matvecs=run)
    c_matvecs = int(run)
    plain_ms = cuda_ms(lambda: K.ev_segment_ref(p, days, T, seed=21), 1)
    rows = sim_batch * T
    x = torch.rand((sim_batch, n), generator=gen, device=dev)
    y = torch.rand((sim_batch, m2), generator=gen, device=dev)
    kt, ct = p.proj.K.t().contiguous(), p.proj.C.t().contiguous()

    def admm_matmuls():
        for _ in range(T):
            torch.matmul(x, ct)
            for _ in range(iters):
                torch.matmul(y, p.proj.C)
                torch.matmul(x, kt)
                torch.matmul(x, ct)
            torch.matmul(x, ct)

    library_ms = cuda_ms(admm_matmuls, 1)
    del x, y
    occ = K.ev_segment_occupancy(m2, admm=True)
    per_cta = occ["warps"] * occ["envs_per_warp"]
    admm_bound = bound(nbytes(p.step_table, p.proj.K)
                       + sim_batch * (8 + 16 * T),
                       f32_ops=rows * iters * 2 * n * n
                       + c_matvecs * 2 * m2 * n)
    print(f"ev_segment ADMM {sim_batch}x{T} ({iters} iterations): kernel "
          f"{admm_ms:.3f} ms (device) = {rows / admm_ms * 1e3:.0f} "
          f"env-steps/s; dual FISTA at the same shape {dual_ms:.3f} ms; "
          f"plain {plain_ms:.3f} ms; yardstick, not called by the port: its "
          f"mat-vecs as {T * (3 * iters + 2)} torch.matmul {library_ms:.3f} "
          f"ms; bound {admm_bound[0]:.4f} ms ({admm_bound[1]}; K mat-vecs "
          f"{rows * iters}, C mat-vecs run {c_matvecs} = "
          f"{c_matvecs / rows:.4f} an env step); {occ['envs_per_warp']} envs "
          f"a warp, {occ['ctas']} CTAs of {occ['warps']} warps resident per SM "
          f"= {occ['ctas'] * occ['warps']} warps, {occ['ctas'] * per_cta} envs; "
          f"{-(-sim_batch // per_cta)} CTAs = "
          f"{sim_batch / (occ['ctas'] * per_cta * sms):.3f} waves on {sms} "
          f"SMs; {occ['registers']} registers, {occ['local_bytes']} bytes of "
          f"local memory (spills) a thread; simulation tier mean reward "
          f"{admm_reward:.6f}, launches {admm_launches} {tag}", flush=True)

    # ---- 19. GMM: a 200-day caltech Summer 2021 bank -------------------
    genv, gp = make("evcharging", trace="gmm", device=dev)
    k = gp.moer_forecast_steps
    D = 2 + 2 * n + k
    days = torch.randint(gp.n_days, (B,), generator=gen, device=dev)
    acts = torch.rand((T, B, n), generator=gen, device=dev)
    check_segment(f"GMM {gp.n_days} days {B}x{T}",
                  K.ev_segment(gp, days, T, actions=acts)[0],
                  K.ev_segment_ref(gp, days, T, actions=acts)[0], tag)
    w = K.pack_policy_weights(init_policy(
        D, n, HIDDEN, torch.Generator().manual_seed(5), dev))
    noise = torch.randn((T, B, n), generator=gen, device=dev)
    check_policy(f"GMM {gp.n_days} days {B}x{T} H={HIDDEN}", n, D,
                 K.ev_policy_segment(gp, w, days, T, noise=noise),
                 K.ev_policy_segment_ref(gp, w, days, T, noise=noise), tag)
    del acts, noise
    K.ev_segment.launches = 0
    sim_gen = torch.Generator(device=dev).manual_seed(22)
    roll = genv.fused_rollout(gp, sim_batch, T, generator=sim_gen)
    gmm_launches = K.ev_segment.launches
    if not bool(torch.isfinite(roll.reward).all()) or gmm_launches == 0:
        fail("GMM simulation tier: bad rewards or no launch")
    gmm_reward = float(roll.reward.mean())
    del roll
    gmm_ms = cuda_ms(lambda: genv.fused_rollout(gp, sim_batch, T,
                                                generator=sim_gen), 3)
    print(f"GMM simulation tier {sim_batch}x{T} ({gp.n_days}-day bank): "
          f"whole fused_rollout call {gmm_ms:.3f} ms (CUDA events) = "
          f"{rows / gmm_ms * 1e3:.0f} env-steps/s; mean reward "
          f"{gmm_reward:.6f}; ev_segment launches {gmm_launches} {tag}",
          flush=True)

    # ---- 20-21. EV float32 trainers: episodic (batch_unroll), generic --
    env, p = make("evcharging", device=dev)
    for label, seed, steps in (("EV episodic", 23, 2), ("EV generic", 24, 3)):
        cfg, cfg0 = trainer_configs(label)
        run_trainer(label, env, p, cfg, cfg0, seed, tag, steps=steps)
        finish_trainer(label, env, p, cfg, seed, tag, want_profile,
                       steps=1 if label == "EV episodic" else 2)

    # ---- 22. the CLI on the card -----------------------------------------
    log = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        train.main(["--env", "evcharging", "--rollout-len", "64",
                    "--eval-every", "1", "--iterations", "2",
                    "--log-dir", log])
        with open(os.path.join(log, "eval_results.csv")) as f:
            rows_csv = f.read().splitlines()
        best = sorted(os.listdir(os.path.join(log, "best_model")))
        print(f"train CLI --rollout-len 64 --eval-every 1 --iterations 2: "
              f"{time.perf_counter() - t0:.3f} s; eval_results.csv "
              f"{rows_csv}; best_model {best} {tag}", flush=True)
        if len(rows_csv) != 3 or rows_csv[0].split(",")[:2] != [
                "iteration", "mean_return"] or not best \
                or not all(np.isfinite(float(r.split(",")[1]))
                           for r in rows_csv[1:]):
            fail("train CLI: bad eval_results.csv or no best_model")
    finally:
        shutil.rmtree(log)
    free_cuda()
    return {"name": "ev_segment_admm", "route": "cuda",
            "source": "sustaingym_tpu_torch/ops/cuda/csrc/ev_rollout.cu",
            "replaces": "sustaingym_tpu/ops/pallas/ev_rollout.py:337",
            "launches": admm_launches, "max_abs_err": err, "ms": admm_ms,
            "plain_ms": plain_ms, "bound_ms": admm_bound[0],
            "bound_by": admm_bound[1], "library_ms": library_ms}


# phases 26-27's trainers, beside the bench's three multi-agent lines:
# label -> (env, make kwargs, PPOConfig kwargs besides HIDDEN and EPOCHS)
MA_CHECKS = {
    "MA building": ("building-multiagent", {},
                    dict(num_envs=1024, minibatches=36)),
    "MA EV discrete": ("evcharging-multiagent",
                       {"project_action": False, "discrete_bins": 5},
                       dict(num_envs=512, rollout_len=64, minibatches=16)),
}


def ma_slice(tag: str, want_profile: bool):
    """Phases 23-27 (module docstring): each multi-agent trainer's captured
    steps, lr=0 step and captured-vs-eager check; the kernels' launch
    counts over the slice (none of them is on its path)."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch.bench import (EPOCHS, HIDDEN, TRAINERS,
                                            make_env)
    from sustaingym_tpu_torch.core.graph import counted_wrappers
    from sustaingym_tpu_torch.parallel import PPOConfig

    dev = torch.device("cuda")
    jobs = []
    for label in ("MA EV", "MA EV delay2", "MA cogen"):
        cfg, cfg0 = trainer_configs(label)
        jobs.append((label, TRAINERS[label][1], TRAINERS[label][2], cfg,
                     cfg0))
    for label, (name, kw, cfg_kw) in MA_CHECKS.items():
        cfg = PPOConfig(hidden=HIDDEN, epochs=EPOCHS, **cfg_kw)
        jobs.append((label, name, kw, cfg, dataclasses.replace(
            cfg, num_envs=min(CHECK_BATCH, cfg.num_envs), minibatches=4,
            epochs=1, lr=0.0)))
    tables = tempfile.mkdtemp(prefix="chip_smoke_ma_tables_")
    for w in counted_wrappers():
        w.launches = 0
    try:
        for seed, (label, name, kw, cfg, cfg0) in enumerate(jobs, 30):
            env, p = make_env(name, dev, tables, **kw)
            # MA-EV: the lr=0 step and the check at the trainer's own 512
            # envs (module docstring)
            batch = min(CHECK_BATCH, cfg.num_envs)
            cfg0 = dataclasses.replace(cfg0, num_envs=batch)
            run_trainer(label, env, p, cfg, cfg0, seed, tag)
            finish_trainer(label, env, p, cfg, seed, tag, want_profile,
                           batch=batch)
    finally:
        shutil.rmtree(tables)
    launches = {w.__name__: w.launches for w in counted_wrappers()}
    print(f"multi-agent slice: kernel launches {launches} (no env kernel "
          f"on this slice's path; ppo_gauss_loss is the shared Gaussian "
          f"policies' loss head) {tag}", flush=True)
    free_cuda()


# phase 28-33's captured-vs-eager batch where the bench's is larger
OFF_POLICY_CHECK = {"DQN MA EV": 128}
# (label, env, params, seed) of each off-policy trainer that ``--profile``
# profiles at the end of the run
OFF_POLICY_PROFILE = []


def carry_tensors(carry: dict) -> dict:
    """Every tensor of an off-policy carry by name: module weights,
    optimizer states, log_alpha, the ring, written, iter, env states and
    obs."""
    import torch
    from torch import nn
    from sustaingym_tpu_torch.core.graph import tree_leaves
    from sustaingym_tpu_torch.parallel.ppo import _adam_state
    out = {}
    for k, v in carry.items():
        if isinstance(v, nn.Module):
            out.update({f"{k}.{n}": t for n, t in v.state_dict().items()})
        elif isinstance(v, torch.optim.Optimizer):
            out.update({f"{k}.{i}": t for i, t in enumerate(_adam_state(v))})
        else:
            out.update({f"{k}.{i}": t for i, t in enumerate(tree_leaves(v))})
    return out


def online_weights(carry: dict) -> dict:
    """The online networks' weights and log_alpha (not the targets)."""
    return {k: t for k, t in carry_tensors(carry).items()
            if k.split(".")[0] in ("actor", "critics", "qnet", "log_alpha")}


def run_off_policy(label: str, env, p, seed: int, tag: str, steps: int = 2):
    """``steps`` captured train steps of off-policy trainer ``label`` at
    the bench's configuration (host clock, synchronised; the first holds
    the graphs' warm-up and capture, printed apart), the peak device memory
    of each step (their difference: the capture's extra), each metric
    finite; every kernel's launches over the steps, counted from 0: on the
    market, ``pdhg_solve_paired`` once a step of the rollout's warm-up
    and of each of its replays (steps x rollout_len, plus one warm-up of
    each one-step rollout graph the reset schedule used), every other
    kernel never. Returns (cfg, the solve kernel's launches)."""
    import torch
    from sustaingym_tpu_torch.bench import off_policy_trainer
    from sustaingym_tpu_torch.core import reset_schedule
    from sustaingym_tpu_torch.core.graph import counted_wrappers
    free_cuda()
    for w in counted_wrappers():
        w.launches = 0
    cfg, init_state, train_step = off_policy_trainer(label, env, p)
    tgen = torch.Generator(device=p.device).manual_seed(seed)
    carry = init_state(tgen)
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    env_steps = cfg.num_envs * cfg.rollout_len
    agents = train_step.n_agents
    graphs = train_step.graphs
    peaks = []
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, tgen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        m = {key: float(v) for key, v in metrics.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{label} train step {i}: non-finite metrics {m}")
        held = (f" (of which {graphs.captures} graphs' warm-up "
                f"{graphs.warmup_s:.3f} s, capture + instantiate "
                f"{graphs.capture_s:.3f} s)" if i == 0 else "")
        per_agent = (f" = {env_steps * agents / dt:.0f} agent-steps/s "
                     f"({agents} agents)" if agents > 1 else "")
        print(f"{label} train step {i}: {dt:.3f} s{held} = "
              f"{env_steps / dt:.0f} env-steps/s{per_agent}; "
              f"{json.dumps(m)} {tag}", flush=True)
    train_step.check(carry)         # the rollout's reset guard
    print(f"{label} trainer: carry (networks, optimizers, ring "
          f"{cfg.capacity} x {cfg.num_envs}) {held_gib:.3f} GiB; peak device "
          f"memory {peaks[0]:.3f} GiB in the first step (the captures), "
          f"{peaks[-1]:.3f} GiB in the last: the capture's extra "
          f"{peaks[0] - peaks[-1]:.3f} GiB {tag}", flush=True)
    launches = {w.__name__: w.launches for w in counted_wrappers()}
    # one launch a rollout step, plus the warm-up of each one-step graph
    # (with and without the reset) that the schedule used
    ep_len = env.episode_steps(p)
    graphs_used = len({r for i in range(steps) for r in reset_schedule(
        ep_len, i * cfg.rollout_len % ep_len, cfg.rollout_len)})
    solves = steps * cfg.rollout_len + graphs_used \
        if env.name == "electricitymarket" else 0
    want = {k: solves if k == "pdhg_solve_paired" else 0 for k in launches}
    print(f"{label}: kernel launches over its {steps} train steps "
          f"{launches} (required: {want}) {tag}", flush=True)
    if launches != want:
        fail(f"{label}: kernel launches {launches}, required {want}")
    del init_state, train_step, carry, graphs
    free_cuda()
    return cfg, launches["pdhg_solve_paired"]


def check_off_policy_lr0(label: str, env, p, seed: int, tag: str,
                         batch: int):
    """One captured train step at lr=0 (and alpha_lr=0 for SAC) at
    ``batch`` envs: every online weight and log_alpha bit-equal, finite
    losses; the targets' Polyak step between equal values printed."""
    import torch
    from sustaingym_tpu_torch.bench import OFF_POLICY, off_policy_trainer
    extra = {"alpha_lr": 0.0} if OFF_POLICY[label][1] == "sac" else {}
    free_cuda()
    _, init_state, train_step = off_policy_trainer(
        label, env, p, num_envs=batch, lr=0.0, **extra)
    gen = torch.Generator(device=p.device).manual_seed(seed)
    carry = init_state(gen)
    before = {k: t.detach().clone() for k, t in online_weights(carry).items()}
    targets = {k: t.detach().clone() for k, t in carry_tensors(carry).items()
               if k.split(".")[0] in ("targets", "target", "actor_target")}
    carry, metrics = train_step(carry, gen)
    m = {k: float(v) for k, v in metrics.items()}
    after = online_weights(carry)
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    now = carry_tensors(carry)
    d_target = max(float((now[k] - t).abs().max()) for k, t in targets.items())
    print(f"{label} lr=0 train step at {batch} envs (captured): online "
          f"weights and log_alpha bit-equal {not moved}; targets max|d| "
          f"{d_target:.3e} (a Polyak step between equal values); {m} {tag}",
          flush=True)
    if moved or not all(np.isfinite(v) for v in m.values()):
        fail(f"{label}: the lr=0 step moved {moved} or its losses are not "
             f"finite: {m}")
    del init_state, train_step, carry
    free_cuda()


def check_off_policy_captured(label: str, env, p, seed: int, tag: str,
                              batch: int):
    """One train step captured against the same step eager at ``batch``
    envs from the same carry and generator state: every tensor of the
    carry (``carry_tensors``), the metrics and the generator state
    bit-equal (CAPTURE_GATE)."""
    import torch
    from sustaingym_tpu_torch.bench import off_policy_trainer
    runs = {}
    for capture in (True, False):
        free_cuda()
        _, init_state, step = off_policy_trainer(label, env, p,
                                                 capture=capture,
                                                 num_envs=batch)
        gen = torch.Generator(device=p.device).manual_seed(seed)
        carry = init_state(gen)
        carry, metrics = step(carry, gen)
        runs[capture] = ({k: t.detach().clone()
                          for k, t in carry_tensors(carry).items()},
                         {k: float(v) for k, v in metrics.items()},
                         gen.get_state())
        del init_state, step, carry
    (tc, mc, gc), (te, me, ge) = runs[True], runs[False]
    differ = [k for k in tc if not torch.equal(tc[k], te[k])]
    d_max = max(float((tc[k].double() - te[k].double()).abs().max())
                for k in tc)
    equal = not differ and mc == me and torch.equal(gc, ge)
    print(f"{label} captured vs eager, 1 train step at {batch} envs: "
          f"{len(tc)} carry tensors, max|d| {d_max:.3e}, differing "
          f"{differ[:6]}; metrics |d| "
          f"{ {k: abs(mc[k] - me[k]) for k in mc} }; generator states equal "
          f"{torch.equal(gc, ge)}; bit-equal {equal} ({CAPTURE_GATE}) {tag}",
          flush=True)
    if not equal:
        fail(f"{label}: the captured train step differs from the eager one")
    del runs, tc, te
    free_cuda()


def off_policy_cli(tag: str):
    """Phase 34: ``train.main`` with ``--algo sac --eval-every 1`` on EV,
    then a resume."""
    import shutil
    import tempfile
    from sustaingym_tpu_torch import train
    log = tempfile.mkdtemp(prefix="chip_smoke_sac_cli_")
    try:
        args = ["--env", "evcharging", "--algo", "sac", "--num-envs", "256",
                "--rollout-len", "16", "--iterations", "2", "--eval-every",
                "1", "--eval-episodes", "4", "--save-every", "2",
                "--log-dir", log, "--env-kwargs",
                '{"project_action": false}']
        t0 = time.perf_counter()
        train.main(args)
        with open(os.path.join(log, "eval_results.csv")) as f:
            rows = f.read().splitlines()
        returns = [float(r.split(",")[1]) for r in rows[1:]]
        if len(returns) != 2 or not all(np.isfinite(returns)):
            fail(f"SAC CLI: eval rows {rows}")
        if not os.listdir(os.path.join(log, "best_model")):
            fail("SAC CLI: no best_model")
        train.main(args + ["--restore", os.path.join(log, "checkpoints"),
                           "--iterations", "1"])
        print(f"SAC CLI: two iterations with --eval-every 1 and a resume "
              f"in {time.perf_counter() - t0:.3f} s; eval returns {returns} "
              f"{tag}", flush=True)
    finally:
        shutil.rmtree(log)


def off_policy_slice(tag: str, want_profile: bool) -> int:
    """Phases 28-34 (module docstring): each off-policy trainer's captured
    steps (with their launch gate), lr=0 step and captured-vs-eager check,
    the SAC CLI; each phase's kernel launches: ``pdhg_solve_paired`` alone
    on the market trainers, none elsewhere. Returns the solve kernel's
    launches in the trainers' captured steps (their main path)."""
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch.bench import OFF_POLICY, make_env
    from sustaingym_tpu_torch.core.graph import counted_wrappers

    dev = torch.device("cuda")
    tables = tempfile.mkdtemp(prefix="chip_smoke_off_policy_tables_")
    t0 = time.perf_counter()
    main_path_solves = 0

    def gate_phase(label: str, market: bool):
        launches = {w.__name__: w.launches for w in counted_wrappers()}
        print(f"{label}: kernel launches over its phase {launches} {tag}",
              flush=True)
        others = {k: v for k, v in launches.items()
                  if v and not (market and k == "pdhg_solve_paired")}
        if others or (market and not launches["pdhg_solve_paired"]):
            fail(f"{label}: kernel launches {launches}")

    try:
        for seed, (label, entry) in enumerate(OFF_POLICY.items(), 40):
            env, p = make_env(entry[2], dev, tables, **entry[3])
            cfg, solves = run_off_policy(label, env, p, seed, tag)
            main_path_solves += solves
            batch = OFF_POLICY_CHECK.get(label, min(CHECK_BATCH,
                                                    cfg.num_envs))
            check_off_policy_lr0(label, env, p, seed, tag, batch)
            check_off_policy_captured(label, env, p, seed, tag, batch)
            gate_phase(label, env.name == "electricitymarket")
            if want_profile:
                OFF_POLICY_PROFILE.append((label, env, p, seed))
        for w in counted_wrappers():
            w.launches = 0
        off_policy_cli(tag)
        gate_phase("SAC CLI", False)
    finally:
        shutil.rmtree(tables)
    print(f"off-policy slice in {time.perf_counter() - t0:.3f} s: "
          f"pdhg_solve_paired launches {main_path_solves} in the market "
          f"trainers' captured steps {tag}", flush=True)
    free_cuda()
    return main_path_solves


def captured_ms(fn, generators=(), reps: int = 3) -> float:
    """Mean ms of one replay of ``fn``, drawing from ``generators``,
    captured alone in a CUDA graph (CUDA events, after the capture's own
    warm-up and one replay)."""
    import torch
    from sustaingym_tpu_torch.core.graph import Graphs
    graphs = Graphs(torch.device("cuda"))
    return cuda_ms(lambda: graphs("alone", fn, generators=generators), reps)


def profile_off_policy(tag: str):
    """``--profile``: each off-policy trainer of ``OFF_POLICY_PROFILE``,
    captured and eager (``capture=False``): the rollout, the updates and
    the whole step on the host clock (synchronised between them, the
    second of two iterations), and over a captured step the device's busy
    time (``torch.profiler``); the market solve's and the whole-batch
    reset's shares of the captured rollout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sustaingym_tpu_torch.bench import off_policy_trainer

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for label, env, p, seed in OFF_POLICY_PROFILE:
        phase_ms = {}
        for capture in (True, False):
            free_cuda()
            cfg, init_state, step = off_policy_trainer(label, env, p,
                                                       capture=capture)
            gen = torch.Generator(device=p.device).manual_seed(seed)
            carry = init_state(gen)
            for _ in range(2):
                roll_ms = timed(lambda: step.rollout(carry, gen))
                upd_ms = timed(lambda: step.update(carry, gen))
                step_ms = timed(lambda: step(carry, gen))
            kind = "captured" if capture else "eager"
            phase_ms[kind] = roll_ms, step_ms
            print(f"profile {label} {kind}: train step {step_ms:.1f} ms; "
                  f"rollout {roll_ms:.1f} ms ({cfg.rollout_len} steps), "
                  f"{cfg.updates} updates {upd_ms:.1f} ms = "
                  f"{upd_ms / cfg.updates:.3f} ms each {tag}", flush=True)
            if capture:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    traced_ms = timed(lambda: step(carry, gen))
                busy_ms = sum(_dev_us(e) for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA and not
                              getattr(e, "is_user_annotation", False)) / 1e3
                print(f"profile {label} captured: device busy "
                      f"{busy_ms:.1f} ms = {busy_ms / step_ms:.1%} of the "
                      f"untraced step {step_ms:.1f} ms (traced "
                      f"{traced_ms:.1f} ms) {tag}", flush=True)
                state = carry["env_states"]
                B, T = cfg.num_envs, cfg.rollout_len
            del init_state, step, carry
        if env.name == "electricitymarket":
            # the SCED solve of one generic step at the carried (warm)
            # state, bids uniform over the action space, T of them
            space = env.action_space(p)
            agen = torch.Generator(device=p.device).manual_seed(seed)
            bids = env._prep_action(p, space.sample_batch(agen, B))

            def solves():
                for _ in range(T):
                    env.clear_market(p, state, bids)
            solve_ms = captured_ms(solves)
            roll_ms, step_ms = phase_ms["captured"]
            print(f"profile {label}: {T} SCED solves at {B} envs captured "
                  f"alone {solve_ms:.1f} ms = {solve_ms / roll_ms:.1%} of "
                  f"the captured rollout {roll_ms:.1f} ms, "
                  f"{solve_ms / step_ms:.1%} of the step {step_ms:.1f} ms "
                  f"(one pdhg_solve_paired launch a step, each env at its "
                  f"own budget) {tag}", flush=True)
        if label in ("SAC EV", "DQN MA EV"):
            rgen = torch.Generator(device=p.device).manual_seed(seed)

            def resets():
                for _ in range(T):
                    env.reset(p, rgen, B)
            reset_ms = captured_ms(resets, generators=(rgen,))
            roll_ms = phase_ms["captured"][0]
            print(f"profile {label}: {T} whole-batch resets at {B} envs "
                  f"captured alone {reset_ms:.1f} ms = "
                  f"{reset_ms / roll_ms:.1%} of the captured rollout "
                  f"{roll_ms:.1f} ms {tag}", flush=True)
        del state
    free_cuda()



# ---- slice 9: the PPO update's bf16 GEMMs, the reset schedule, ranks --

def bf16_gemm_gate(tag: str):
    """Phase 37: the PPO learner's three bf16-valued products at the EV
    trainer's minibatch rows (8192 x 288 / 96), H = 256: the bf16 GEMM
    with float32 output (``ppo_trunk.bf16_matmul``) and the float32 route
    of the same bf16 values, each against the float64 product, gated by
    ``GEMM_GATE`` per output; both routes' largest error over its bound
    printed, and their times (CUDA events)."""
    import torch
    from sustaingym_tpu_torch.bench import TRAINERS
    from sustaingym_tpu_torch.ops.cuda.ppo_trunk import bf16_matmul
    cfg = TRAINERS["EV"][3]
    rows = cfg["num_envs"] * STEPS // cfg["minibatches"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)
    n = 54
    for name, k, m in (("obs x trunk1", 2 + 2 * n + 36, 256),
                       ("h1 x trunk2", 256, 256),
                       ("h2 x [mu; value]", 256, n + 1)):
        a = torch.randn((rows, k), generator=g, device=dev).bfloat16()
        w = torch.randn((m, k), generator=g, device=dev).bfloat16()
        ref = a.double() @ w.double().t()
        bound = 2.0 ** -24 * (a.double().abs() @ w.double().abs().t())
        ratio = {}
        for route, fn in (("bf16 GEMM", lambda: bf16_matmul(a, w)),
                          ("float32", lambda: a.float() @ w.float().t())):
            out = fn()
            ratio[route] = float(((out.double() - ref).abs()
                                  / bound.clamp_min(1e-300)).max())
            ratio[route + " ms"] = cuda_ms(fn, 20)
        print(f"bf16 GEMM gate {name} ({rows} x {k} x {m}): largest "
              f"|error| / (2^-24 sum|a b|): bf16 GEMM "
              f"{ratio['bf16 GEMM']:.3f}, float32 route "
              f"{ratio['float32']:.3f} (gate {GEMM_GATE}); "
              f"{ratio['bf16 GEMM ms']:.4f} ms vs "
              f"{ratio['float32 ms']:.4f} ms {tag}", flush=True)
        if max(ratio["bf16 GEMM"], ratio["float32"]) > GEMM_GATE:
            fail(f"bf16 GEMM gate {name}: {ratio}")
        del a, w, ref, bound
    free_cuda()


def fused_update_splits(tag: str):
    """Phase 38: the captured EV and fused building trainers at the
    bench's size, one train step each (host clock), then the update's
    device time by kind (``update_split``)."""
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch import bench
    from sustaingym_tpu_torch.parallel import make_train_step
    dev = torch.device("cuda")
    tables = tempfile.mkdtemp(prefix="chip_smoke_split_tables_")
    try:
        for label in UPDATE_SPLIT:
            _, name, make_kwargs, _ = bench.TRAINERS[label]
            env, p = bench.make_env(name, dev, tables, **make_kwargs)
            cfg = bench.train_config(label)
            init_state, step = make_train_step(env, p, cfg)
            gen = torch.Generator(device=dev).manual_seed(38)
            carry = init_state(gen)
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry, m = step(carry, gen)
                m = {k: float(v) for k, v in m.items()}
                dt = time.perf_counter() - t0
                print(f"{label} captured train step {i}: {dt:.4f} s; "
                      f"{json.dumps(m)} {tag}", flush=True)
            update_split(f"{label} captured", step, carry, gen, cfg, tag)
            del init_state, step, carry
            free_cuda()
    finally:
        shutil.rmtree(tables)


def reset_schedule_slice(tag: str):
    """Phase 39: the generic rollouts reset only at the steps that end
    every episode. The EV generic trainer (8192 x 64, projection on) and
    SAC EV (2048 x 64): nine captured rollout phases from a fresh carry
    (the clock from 0 to 576: two with a reset), each timed (CUDA
    events), the guard read (0); then captured against eager over five
    train steps at 1024 envs (crossing the reset: ``check_captured``)."""
    import torch
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.bench import off_policy_trainer
    from sustaingym_tpu_torch.core import reset_schedule
    from sustaingym_tpu_torch.parallel import make_train_step
    dev = torch.device("cuda")
    cfg, _ = trainer_configs("EV generic")
    env, p = make("evcharging", device=dev)
    sac_env, sac_p = make("evcharging", device=dev, project_action=False)
    for label in ("EV generic", "SAC EV"):
        free_cuda()
        gen = torch.Generator(device=dev).manual_seed(39)
        if label == "SAC EV":
            _, init_state, step = off_policy_trainer(label, sac_env, sac_p)
            carry = init_state(gen)

            def roll():
                step.rollout(carry, gen)
        else:
            init_state, step = make_train_step(env, p, cfg)
            carry = init_state(gen)

            def roll():
                step.rollout(carry["policy"], gen, carry)
        times = []
        for _ in range(9):
            phase = int(carry["env_phase"])
            times.append((phase, any(reset_schedule(STEPS, phase, 64)),
                          cuda_ms(roll, 1)))
        step.check(carry)
        guard = int(carry["reset_guard"])
        resets = [t for _, r, t in times[1:] if r]
        plain = [t for _, r, t in times[1:] if not r]
        print(f"{label} rollout (64 steps, captured): "
              f"{', '.join(f'clock {ph}: {t:.3f} ms' for ph, _, t in times)}; "
              f"without a reset {np.mean(plain):.3f} ms, with one "
              f"{np.mean(resets):.3f} ms (the first holds the captures); "
              f"reset guard {guard} {tag}", flush=True)
        if guard:
            fail(f"{label}: the reset guard reads {guard}")
        del init_state, step, carry
    free_cuda()
    check_captured("EV generic", env, p, cfg, 39, tag, steps=5)


def rank_line(label: str, r: dict) -> str:
    return (f"rank {r['rank']}: path {r['path']}, launches {r['launches']}, "
            f"wall {r['wall']:.3f} s (timed steps {r['seconds']:.3f} s), "
            f"peak device memory {r['peak_gib']:.3f} GiB")


def distribution_slice(tag: str):
    """Phase 40: the data-parallel slice on the one card, as two gloo
    ranks sharing it (NCCL needs a card a rank). ``ev_policy_segment`` and
    ``building_policy_segment`` at their main-path shapes (8192 x 288, H =
    256): the launch over each rank's half (``env_offset`` 0 and 4096) and
    over an unaligned split bit-equal to the full launch's rows; then, each
    against one rank on the same global batch (``bench_scaling``): two
    dp = 2 PPO train steps of the EV fused trainer (8192 global envs x
    288, 96 minibatches; the largest metric difference, the parameters
    bit-equal across the ranks, each rank's kernel launches), the same at
    lr = 0 and 1024 envs (gate: every metric within ``DP_GATE``), one dp =
    2 SAC EV step (2048 x 64), one dp = 1 x mp = 2 step of MA cogen
    (4096 x 96, 24 minibatches) and two at lr = 0 and 512 envs (gate: the
    exact-ratio invariant on every rank);
    each rank's wall time and peak memory. At lr > 0 Adam's first steps
    carry the sums' reassociation into every parameter (a gradient near 0
    takes a step of about lr of either sign), so those differences are
    printed, not gated."""
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch import bench
    from sustaingym_tpu_torch.bench import HIDDEN
    from sustaingym_tpu_torch.bench_scaling import rank_run, run_ranks
    from sustaingym_tpu_torch.ops.cuda import building_rollout as K5
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    from sustaingym_tpu_torch.parallel import init_policy

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    B = bench.TRAINERS["EV"][3]["num_envs"]
    tables = tempfile.mkdtemp(prefix="chip_smoke_dp_tables_")
    try:
        _, p = bench.make_env("evcharging", dev, tables)
        n, k = p.n_stations, p.moer_forecast_steps
        w = K.pack_policy_weights(init_policy(
            2 + 2 * n + k, n, HIDDEN, torch.Generator().manual_seed(3),
            dev))
        days = torch.randint(p.n_days, (B,), generator=g, device=dev)
        _, bp = bench.make_env("building", dev, tables)
        bw = K.pack_policy_weights(init_policy(
            bp.n + 4, bp.n, HIDDEN, torch.Generator().manual_seed(4),
            dev))
        epochs = torch.randint(bp.length_of_weather - STEPS, (B,),
                               generator=g, device=dev)
        for name, fn in (
                ("ev_policy_segment", lambda o, b: K.ev_policy_segment(
                    p, w, days[o:o + b], STEPS, seed=41, env_offset=o)),
                ("building_policy_segment",
                 lambda o, b: K5.building_policy_segment(
                     bp, bw, epochs[o:o + b], STEPS, seed=42,
                     env_offset=o))):
            full = fn(0, B)
            equal = {}
            for o, b in ((0, B // 2), (B // 2, B // 2), (1000, 3001)):
                part = fn(o, b)
                equal[(o, b)] = all(torch.equal(x, y[:, o:o + b])
                                    for x, y in zip(part, full))
            print(f"{name} {B} x {STEPS} H={HIDDEN}: the launches at "
                  f"env_offset o over b envs bit-equal to rows [o, o + b) "
                  f"of the full launch: {equal} {tag}", flush=True)
            if not all(equal.values()):
                fail(f"{name}: an env_offset launch differs from the full "
                     f"launch's rows")
            del full, part
    finally:
        shutil.rmtree(tables)
    del w, bw, days, epochs
    free_cuda()

    ev = {"num_envs": B, "rollout_len": None, "hidden": HIDDEN,
          "minibatches": bench.TRAINERS["EV"][3]["minibatches"],
          "epochs": 4, "obs_bf16": True}
    cogen = {"num_envs": 4096, "rollout_len": 96, "hidden": HIDDEN,
             "minibatches": 24, "epochs": 4, "reward_scale": 1e-4}
    # (label, env, algo, config, mp, make kwargs, train steps, gate): the
    # gate "close" holds every metric to one rank's within DP_GATE; "ratio"
    # holds the exact-ratio invariant on every rank (|pg_loss| < 1e-5 at
    # lr = 0: the update's forward through the split equals the
    # scoring's). Cogen's metrics are not held to one rank's: its plant
    # thresholds its switch actions, so float32 reassociation in the
    # forward moves some envs' trajectories
    cases = (
        ("EV fused dp=2", "evcharging", "ppo", ev, 1, {}, 2, None),
        ("EV fused dp=2 lr=0", "evcharging", "ppo",
         {**ev, "num_envs": CHECK_BATCH, "minibatches": 12, "lr": 0.0}, 1,
         {}, 2, "close"),
        ("SAC EV dp=2", "evcharging", "sac",
         {"num_envs": 2048, "rollout_len": 64, "hidden": HIDDEN}, 1,
         {"project_action": False}, 1, None),
        ("MA cogen dp=1 x mp=2", "cogen-multiagent", "ppo", cogen, 2, {}, 1,
         None),
        ("MA cogen dp=1 x mp=2 lr=0", "cogen-multiagent", "ppo",
         {**cogen, "num_envs": 512, "minibatches": 3, "lr": 0.0}, 2, {}, 2,
         "ratio"))
    for label, name, algo, cfg, mp, kw, steps, gate in cases:
        free_cuda()
        one = rank_run(name, algo, cfg, 1, steps - 1, 43, "cuda", kw)
        free_cuda()
        two = run_ranks(2, name, algo, cfg, mp=mp, steps=steps - 1, seed=43,
                        device="cuda", make_kwargs=kw)
        diff = {key: max(abs(a[key] - r["metrics"][i][key])
                         for r in two for i, a in enumerate(one["metrics"]))
                for key in one["metrics"][0]}
        rel = max(abs(a[key] - r["metrics"][i][key])
                  / max(abs(a[key]), DP_GATE[1])
                  for r in two for i, a in enumerate(one["metrics"])
                  for key in a)
        same = len({r["params"] for r in two}) == 1
        print(f"{label}: {steps} train step(s) on 2 gloo ranks "
              f"sharing the card against 1 rank, global batch "
              f"{cfg['num_envs']}: metrics max|d| {diff}, largest "
              f"|d| / max(|one rank|, {DP_GATE[1]}) {rel:.3e}; parameters "
              f"bit-equal across the ranks {same}; one rank: "
              f"{rank_line(label, one)}; "
              + "; ".join(rank_line(label, r) for r in two) + f" {tag}",
              flush=True)
        if not same:
            fail(f"{label}: the ranks' parameters differ")
        if gate == "close" and rel > DP_GATE[0]:
            fail(f"{label}: dp = 2 differs from one rank by {rel:.3e}")
        if gate == "ratio":
            pg = max(abs(m["pg_loss"]) for r in two for m in r["metrics"])
            print(f"{label}: largest |pg_loss| on the ranks {pg:.3e} "
                  f"(gate < 1e-5) {tag}", flush=True)
            if not pg < 1e-5:
                fail(f"{label}: lr = 0 exact-ratio invariant broken "
                     f"through the split: |pg_loss| {pg}")
        if name == "evcharging" and algo == "ppo" and not all(
                r["launches"].get("ev_policy_segment") for r in two):
            fail(f"{label}: a rank launched no ev_policy_segment")
    free_cuda()


# ---- slice 10: the debug checks, the examples, --profile ----------------

# phase 41: (label, env, make kwargs, batch, check_bounds) at the bench's
# widths. check_bounds as tests/test_torch_debug.py settles it: the
# building's obs leave its declared bounds within an episode in both
# packages (phase 41 shows the port fails there too, then runs it
# without); the MA EV and MA cogen views declare the base env's Dict space
# over a flat obs array, which neither package's bounds walk reads
DEBUG_RUNS = (
    ("EV", "evcharging", {}, 8192, True),
    ("building", "building", {}, 8192, False),
    ("cogen", "cogen", {}, 8192, True),
    ("datacenter", "datacenter", {}, 4096, True),
    ("market", "electricitymarket", {}, 4096, True),
    ("MA EV", "evcharging-multiagent",
     {"project_action": False, "periods_delay": 0}, 512, False),
    ("MA cogen", "cogen-multiagent", {}, 4096, False),
    ("MA building", "building-multiagent", {}, 1024, False),
)
BOUNDS_FAIL = "obs outside declared observation-space bounds"
NAN_BATCH, NAN_STEPS = 8192, 8


def launch_counts() -> dict:
    from sustaingym_tpu_torch.core.graph import counted_wrappers
    return {w.__name__: w.launches for w in counted_wrappers()}


def zero_launches():
    from sustaingym_tpu_torch.core.graph import counted_wrappers
    for w in counted_wrappers():
        w.launches = 0


class NaNEnv:
    """A functional env of ``batch`` envs whose reward turns NaN after
    step 3 (the JAX package's test env, tests/test_debug_distributed.py)."""

    name = "nan-test"

    def reset(self, params, generator, batch):
        import torch
        from sustaingym_tpu_torch.core import TimeStep
        dev = generator.device
        flag = torch.zeros(batch, dtype=torch.bool, device=dev)
        return (torch.zeros(batch, dtype=torch.int32, device=dev),
                TimeStep(obs=torch.zeros((batch, 2), device=dev),
                         reward=torch.zeros(batch, device=dev),
                         terminated=flag, truncated=flag.clone(), info={}))

    def step(self, params, state, action, generator=None):
        import torch
        from sustaingym_tpu_torch.core import TimeStep
        t = state + 1
        flag = torch.zeros_like(t, dtype=torch.bool)
        return t, TimeStep(
            obs=torch.zeros((t.shape[0], 2), device=t.device),
            reward=torch.where(t > 3, torch.nan, 1.0), terminated=flag,
            truncated=flag.clone(), info={"load": action.sum(-1)})

    def observation_space(self, params):
        from sustaingym_tpu_torch.core import Box
        return Box(-1.0, 1.0, (2,))

    def action_space(self, params):
        from sustaingym_tpu_torch.core import Box
        return Box(-1.0, 1.0, (1,))

    def episode_steps(self, params):
        return None


def debug_slice(tag: str) -> dict:
    """Phase 41 (module docstring): ``validate_batch_rollout`` over one
    episode of each env of ``DEBUG_RUNS``, checked against unchecked from
    the same generator state; the NaN env eager and captured. Returns the
    kernel launches of its env runs."""
    import shutil
    import tempfile

    import torch
    from sustaingym_tpu_torch.bench import make_env
    from sustaingym_tpu_torch.core.graph import Graphs, tree_leaves
    from sustaingym_tpu_torch.utils import debug

    dev = torch.device("cuda")
    tables = tempfile.mkdtemp(prefix="chip_smoke_debug_tables_")
    total = {}
    try:
        for seed, (label, name, kw, batch, bounds) in enumerate(DEBUG_RUNS,
                                                                 41):
            env, p = make_env(name, dev, tables, **kw)
            steps = env.episode_steps(p)
            gen = torch.Generator(device=dev).manual_seed(seed)
            debug.validate_batch_rollout(env, p, gen, batch, 2, bounds)
            if name.startswith("building"):
                gen.manual_seed(seed)
                try:
                    debug.validate_batch_rollout(env, p, gen, batch, steps,
                                                 True)
                    fail(f"{label}: the bounds check passed, where the JAX "
                         f"env fails it")
                except debug.CheckError as e:
                    if str(e) != BOUNDS_FAIL:
                        fail(f"{label}: {e}")
                print(f"{label} {batch}x{steps}: check_bounds raises "
                      f"{BOUNDS_FAIL!r}, as the JAX env does; timed "
                      f"without bounds {tag}", flush=True)
            zero_launches()
            runs = {True: [], False: []}
            # in turns (checked, unchecked, unchecked, checked): the eager
            # loops are host-bound, and their times drift within a call
            for armed in (True, False, False, True):
                gen.manual_seed(seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = debug.validate_batch_rollout(env, p, gen, batch, steps,
                                                   bounds, armed=armed)
                torch.cuda.synchronize()
                runs[armed].append((time.perf_counter() - t0, out))
            launches = {k: v for k, v in launch_counts().items() if v}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            sums = [out for side in runs.values() for _, out in side]
            if not all(torch.equal(x.view(torch.int32), sums[0].view(
                    torch.int32)) for x in sums):
                fail(f"{label}: reward sums checked and unchecked "
                     f"{[float(x) for x in sums]}")
            tc = [t for t, _ in runs[True]]
            tu = [t for t, _ in runs[False]]
            print(f"{label} {batch}x{steps} check_bounds={bounds}: checked "
                  f"{tc[0]:.3f} / {tc[1]:.3f} s, unchecked {tu[0]:.3f} / "
                  f"{tu[1]:.3f} s (best {min(tc) / min(tu) - 1:+.1%}); "
                  f"reward sums bit-equal {float(sums[0])!r}; kernel "
                  f"launches (four runs) {launches} {tag}", flush=True)
            del env, p
            free_cuda()
    finally:
        shutil.rmtree(tables)

    # the NaN env: the eager rollout, then a checked step loop captured
    env, batch = NaNEnv(), NAN_BATCH
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        debug.validate_batch_rollout(env, None, gen, batch, NAN_STEPS)
        fail("NaN env: validate_batch_rollout did not raise")
    except debug.CheckError as e:
        if str(e) != "non-finite reward":
            fail(f"NaN env: {e}")
    step = debug.checked_step(env)
    policy_space = env.action_space(None)

    def loop(state, ts0):
        # the reset's table lacks the step's info entry: merge renumbers
        err, rewards = debug.check_timestep(ts0), []
        for _ in range(NAN_STEPS):
            action = policy_space.sample_batch(gen, batch)
            (state, ts), e = step(None, state, action)
            err = err.merge(e)
            rewards.append(ts.reward)
        return state, torch.stack(rewards), err

    state0, ts0 = env.reset(None, gen, batch)
    gen_state = gen.get_state()
    eager = loop(state0.clone(), ts0)
    gen.set_state(gen_state)
    graphs = Graphs(dev)
    captured = graphs("nan-loop", loop, state0, ts0, generators=(gen,))
    same = all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
               for a, b in zip(tree_leaves(eager), tree_leaves(captured)))
    if not same or captured[2].messages != eager[2].messages:
        fail("NaN env: the captured checked loop differs from the eager one")
    for how, err in (("eager", eager[2]), ("captured", captured[2])):
        try:
            err.throw()
            fail(f"NaN env: the {how} checked loop did not raise")
        except debug.CheckError as e:
            if str(e) != "non-finite reward":
                fail(f"NaN env {how}: {e}")
    print(f"NaN env {batch} envs x {NAN_STEPS} steps: validate_batch_rollout "
          f"raises 'non-finite reward'; the checked step loop captured "
          f"({graphs.captures} graph) raises it after its replay, as the "
          f"eager loop does, its outputs bit-equal to the eager loop's "
          f"{tag}", flush=True)
    del graphs, captured, eager
    free_cuda()
    return total


def examples_slice(tag: str):
    """Phase 42 (module docstring): the validate_envs and
    train_multiagent_cogen examples on the card."""
    import shutil
    import tempfile

    from sustaingym_tpu_torch.envs.evcharging import plot_utils
    from sustaingym_tpu_torch.examples import (train_multiagent_cogen,
                                               validate_envs)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        t0 = time.perf_counter()
        stats = validate_envs.main(["--batch", "4096", "--building-tables",
                                    os.path.join(tmp, "tables")])
        if sorted(s["env"] for s in stats) != sorted(
                validate_envs.EPISODE_LEN):
            fail(f"validate_envs: {stats}")
        print(f"validate_envs at 4096 envs: {time.perf_counter() - t0:.3f} "
              f"s {tag}", flush=True)
        log = os.path.join(tmp, "cogen_ma")
        t0 = time.perf_counter()
        train_multiagent_cogen.main([
            "--num-envs", "4096", "--rollout-len", "96", "--minibatches",
            "24", "--iterations", "2", "--save-every", "2", "--log-dir",
            log])
        df = plot_utils.read_train_log(log)
        if len(df) != 2 or not np.isfinite(df["mean_reward"]).all():
            fail(f"train_multiagent_cogen: {df}")
        print(f"train_multiagent_cogen 4096 x 96, two iterations: "
              f"{time.perf_counter() - t0:.3f} s, mean_reward "
              f"{list(df['mean_reward'])} {tag}", flush=True)
    finally:
        shutil.rmtree(tmp)
    free_cuda()


def trace_busy(events, window) -> float:
    """The share of ``window`` (start, end in us) in which the trace's
    device events (kernels, copies, memsets) ran: their union over it."""
    spans = sorted((max(e["ts"], window[0]),
                    min(e["ts"] + e.get("dur", 0), window[1]))
                   for e in events)
    busy, end = 0.0, window[0]
    for a, b in spans:
        if b <= a:
            continue
        if a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = max(end, b)
    return busy / (window[1] - window[0])


# the argument that makes chip_smoke.py phase 43's child process
PROFILE_CHILD = "--profile-child"


def profile_argv(log_dir: str) -> list:
    """``examples.train_ppo``'s arguments in phase 43: the bench's EV fused
    trainer, four iterations, ``--profile``."""
    from sustaingym_tpu_torch.bench import HIDDEN, TRAINERS
    cfg = TRAINERS["EV"][3]
    return ["--env", "evcharging", "--num-envs", str(cfg["num_envs"]),
            "--rollout-len", str(STEPS), "--minibatches",
            str(cfg["minibatches"]), "--obs-bf16", "--hidden", str(HIDDEN),
            "--epochs", "4", "--iterations", "4", "--save-every", "4",
            "--profile", "--log-dir", log_dir]


def profile_child(log_dir: str) -> int:
    """Phase 43's child process: every launch count set to 0, the
    ``--profile`` run into ``log_dir``, then one JSON line of its wall
    seconds and the launches it counted."""
    from sustaingym_tpu_torch.examples import train_ppo
    zero_launches()
    t0 = time.perf_counter()
    train_ppo.main(profile_argv(log_dir))
    wall = time.perf_counter() - t0
    print(json.dumps({"wall": wall, "launches": launch_counts()}))
    return 0


def profile_slice(tag: str) -> dict:
    """Phase 43 (module docstring): ``examples.train_ppo --profile`` at the
    bench's EV fused trainer configuration, in a child process; the trace
    read back. Returns the kernel launches of the run."""
    import shutil
    import tempfile

    from sustaingym_tpu_torch.bench import HIDDEN, TRAINERS
    from sustaingym_tpu_torch.envs.evcharging import plot_utils

    cfg = TRAINERS["EV"][3]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    free_cuda()
    try:
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), PROFILE_CHILD, tmp],
            capture_output=True, text=True, timeout=600)
        lines = child.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"  --profile run: {line}", flush=True)
        if child.returncode or not lines:
            fail(f"--profile run exited {child.returncode}: "
                 f"{child.stderr[-3000:]}")
        result = json.loads(lines[-1])
        wall = result["wall"]
        launches = {k: v for k, v in result["launches"].items() if v}
        if not launches.get("ev_policy_segment"):
            fail(f"--profile run: no ev_policy_segment launch {launches}")
        path = os.path.join(tmp, "profile", "trace_rank0.json")
        t0 = time.perf_counter()
        with open(path) as f:
            trace = json.load(f)
        size = os.path.getsize(path)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        iters = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("iteration ")]
        device = [e for e in events if e.get("ph") == "X" and e.get("cat")
                  in ("kernel", "gpu_memcpy", "gpu_memset")]
        kernels = [e for e in device if e["cat"] == "kernel"]
        if sorted(e["name"] for e in iters) != ["iteration 1", "iteration 2",
                                                "iteration 3"]:
            fail(f"--profile trace: iterations {[e['name'] for e in iters]}")
        if not any("ev_policy_segment" in e["name"] for e in kernels):
            fail("--profile trace: no ev_policy_segment kernel")
        window = (min(e["ts"] for e in iters),
                  max(e["ts"] + e["dur"] for e in iters))
        busy = trace_busy(device, window)
        by_name = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        df = plot_utils.read_train_log(tmp)
        if len(df) != 4 or not np.isfinite(df["mean_reward"]).all():
            fail(f"--profile run: train_results.csv {df}")
        print(f"--profile: EV fused trainer {cfg['num_envs']} x {STEPS}, "
              f"H = {HIDDEN}, bf16 obs, {cfg['minibatches']} minibatches, "
              f"4 iterations in {wall:.3f} s; trace of iterations 1-3 "
              f"{size} bytes, {len(kernels)} kernel events, read in "
              f"{time.perf_counter() - t0:.3f} s; window "
              f"{(window[1] - window[0]) / 1e3:.3f} ms, device busy "
              f"{busy:.4f}; kernel launches {launches}; read_train_log "
              f"{len(df)} rows {tag}", flush=True)
        for name, us in top:
            print(f"--profile top kernel: {us / 1e3:.3f} ms "
                  f"({us / (window[1] - window[0]):.4f} of the window) "
                  f"{name[:160]} {tag}", flush=True)
    finally:
        shutil.rmtree(tmp)
    return launches


def gmm_fit_slice(tag: str):
    """Phase 44 (module docstring): ``fit_gmm``'s EM on the card against
    the same EM on the CPU, both from the host's k-means labels."""
    from sustaingym_tpu_torch.data import ev_gmm

    site, period, draw_seed = GMM_DRAW
    k, seed = GMM_FIT
    d = ev_gmm.load_gmm(site, period)
    s = ev_gmm.sample_gmm(d["weights"], d["means"], d["covariances"],
                          int(d["count"].sum()), draw_seed)
    X = s[((s[:, :3] >= 0) & (s[:, :3] < 1)).all(1) & (s[:, 3] >= 0)]
    t0 = time.perf_counter()
    labels = ev_gmm.kmeans_labels(X, k, np.random.RandomState(seed))
    kmeans_s = time.perf_counter() - t0
    fits, secs = {}, []
    for device in ("cuda", "cpu", "cuda"):
        t0 = time.perf_counter()
        fits[device] = ev_gmm.em_fit(X, labels, n_components=k,
                                     device=device)
        secs.append(time.perf_counter() - t0)
    card, cpu = fits["cuda"], fits["cpu"]
    diffs = {key: float(np.abs(card[key] - cpu[key]).max())
             for key in ("weights", "means", "covariances")}
    lb_diff = abs(card["lower_bound"] - cpu["lower_bound"])
    generator = ev_gmm.mean_log_likelihood(X, d["weights"], d["means"],
                                           d["covariances"])
    print(f"GMM fit {len(X)} x 4 ({site} {period} draw), k = {k}, seed "
          f"{seed}: lower bound card {card['lower_bound']:.8f} CPU "
          f"{cpu['lower_bound']:.8f} (|d| {lb_diff:.3e}), iterations "
          f"{card['n_iter']} / {cpu['n_iter']}, converged "
          f"{card['converged']} / {cpu['converged']}, max |d| {diffs}; "
          f"k-means on the host {kmeans_s:.4f} s; EM card {secs[0]:.4f} s "
          f"(first call), {secs[2]:.4f} s (second), CPU {secs[1]:.4f} s; "
          f"the generating mixture's mean log-likelihood {generator:.6f} "
          f"{tag}", flush=True)
    if (card["n_iter"] != cpu["n_iter"]
            or card["converged"] != cpu["converged"]
            or not lb_diff < GMM_GATE[1]
            or not max(diffs.values()) < GMM_GATE[0]
            or not np.isfinite(card["covariances"]).all()):
        fail(f"GMM fit: the card's EM disagrees with the CPU's (gate "
             f"{GMM_GATE})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    jax_tree = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sustaingym_tpu")
    jax_files = tree_state(jax_tree)
    want_profile = "--profile" in sys.argv[1:]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.bench import HIDDEN, SIM_TIERS, TRAINERS
    from sustaingym_tpu_torch.ops.cuda import build
    from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
    from sustaingym_tpu_torch.ops.cuda import ppo_loss as KL
    from sustaingym_tpu_torch.ops.cuda import ppo_trunk as KT
    from sustaingym_tpu_torch.parallel import init_policy

    # plain versions are the oracle: full-f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == [PROFILE_CHILD]:
        return profile_child(sys.argv[2])

    # ---- 1. card --------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(f"card: {card}; torch.cuda device: {kind}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("ev_rollout", "exog_gather", "cogen_rollout", "dc_rollout",
               "lp_solve", "building_rollout", "ppo_loss", "ppo_trunk")
    build.load_libraries(sources, verbose=True)
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.3f} s {tag}", flush=True)

    dev = torch.device("cuda")
    sim_batch, train_envs = (SIM_TIERS["evcharging"],
                             TRAINERS["EV"][3]["num_envs"])
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
    days = torch.randint(p.n_days, (sim_batch,), generator=gen, device=dev)
    ko, acts = K.ev_segment(p, days, STEPS, seed=7, record_actions=True)
    ro, _ = K.ev_segment_ref(p, days, STEPS, actions=acts)
    e = check_segment(f"caltech projection=on {sim_batch}x{STEPS} in-kernel "
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
    days = torch.randint(p.n_days, (train_envs,), generator=gen, device=dev)
    noise = torch.randn((STEPS, train_envs, n), generator=gen, device=dev)
    e = check_policy(f"caltech projection=on {train_envs}x{STEPS} H={HIDDEN}",
                     n, D, K.ev_policy_segment(p, w, days, STEPS, noise=noise),
                     K.ev_policy_segment_ref(p, w, days, STEPS, noise=noise),
                     tag)
    err["ev_policy_segment"] = max(err["ev_policy_segment"], e)
    del noise
    pol_ms = device_ms(lambda: K.ev_policy_segment(p, w, days, STEPS, seed=3),
                       "ev_policy_segment_launch", 3)
    _, p_off = make("evcharging", project_action=False, device=dev)
    pol_off_ms = device_ms(lambda: K.ev_policy_segment(p_off, w, days, STEPS,
                                                       seed=3),
                           "ev_policy_segment_launch", 3)
    pol_call_ms = cuda_ms(lambda: K.ev_policy_segment(p, w, days, STEPS,
                                                      seed=3), 3)
    pol_plain_ms = cuda_ms(lambda: K.ev_policy_segment_ref(
        p, w, days, STEPS, seed=3), 1)
    ctas = K.ev_policy_occupancy(D, HIDDEN, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = -(-train_envs // 16)
    print(f"ev_policy_segment {train_envs}x{STEPS} H={HIDDEN}: kernel "
          f"{pol_ms:.3f} ms (device) with the projection on, "
          f"{pol_off_ms:.3f} ms with it off (the projection "
          f"{pol_ms - pol_off_ms:.3f} ms); plain {pol_plain_ms:.3f} ms; "
          f"{ctas} CTAs of 16 warps resident per SM = {16 * ctas} warps, "
          f"{grid} CTAs = {grid / (ctas * sms):.3f} waves on {sms} SMs "
          f"{tag}", flush=True)
    print(f"ev_policy_segment {train_envs}x{STEPS}: whole wrapper call "
          f"{pol_call_ms:.3f} ms (CUDA events) {tag}", flush=True)
    obs = torch.randn((train_envs, D), generator=gen, device=dev).bfloat16()
    hid = torch.randn((train_envs, HIDDEN), generator=gen,
                      device=dev).bfloat16()

    def actor_matmuls():
        for _ in range(STEPS):
            torch.matmul(obs, w.w1)
            torch.matmul(hid, w.w2)
            torch.matmul(hid, w.wm)

    print(f"yardstick, not called by the port: the actor's three bf16 "
          f"torch.matmul per step at {train_envs} rows x {STEPS} steps "
          f"{cuda_ms(actor_matmuls, 2):.3f} ms (CUDA events) {tag}",
          flush=True)
    del obs, hid

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

    # the PPO loss head at the EV trainer's minibatch rows
    cfg, cfg0 = trainer_configs("EV")
    loss_args = ppo_loss_inputs(cfg.num_envs * STEPS // cfg.minibatches, n,
                                gen)
    err["ppo_gauss_loss"] = check_ppo_loss(loss_args, tag)
    # the trunk's passes at the same rows, hidden 256, the EV obs to copy
    trunk_args = trunk_inputs(loss_args[0].shape[0], HIDDEN, D, gen)
    err["ppo_trunk"] = check_ppo_trunk(trunk_args, tag)

    # ---- main path: counts from 0 -----------------------------------------
    K.ev_segment.launches = 0
    K.ev_policy_segment.launches = 0
    KL.ppo_gauss_loss.launches = 0
    KT.ppo_trunk.launches = 0

    # ---- 5. simulation tier -----------------------------------------------
    sim_gen = torch.Generator(device=dev).manual_seed(11)
    roll = env.fused_rollout(p, sim_batch, STEPS, generator=sim_gen)
    if roll.reward.shape != (STEPS, sim_batch) \
            or not bool(torch.isfinite(roll.reward).all()):
        fail("simulation tier: bad rewards")
    ev_mean_reward = float(roll.reward.mean())
    del roll

    # ---- 6. trainer --------------------------------------------------------
    run_trainer("EV", env, p, cfg, cfg0, 21, tag)

    launches = {"ev_segment": K.ev_segment.launches,
                "ev_policy_segment": K.ev_policy_segment.launches,
                "ppo_gauss_loss": KL.ppo_gauss_loss.launches,
                "ppo_trunk": KT.ppo_trunk.launches}
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    # one a minibatch (epochs x minibatches a step) and each trainer's one
    # warm-up of its captured update: the two steps, then the lr=0 step
    want_loss = (2 * cfg.epochs * cfg.minibatches + 1
                 + cfg0.epochs * cfg0.minibatches + 1)
    # the trunk's passes: four a minibatch (two forward, two backward) and
    # two a scoring, each step's, plus each trainer's warm-ups of its
    # captured update (one minibatch) and scoring
    def trunk_step(c):
        return 4 * c.epochs * c.minibatches + 2
    want_trunk = 2 * trunk_step(cfg) + trunk_step(cfg0) + 2 * (4 + 2)
    print(f"EV main path: ppo_gauss_loss launches {launches['ppo_gauss_loss']}"
          f" over two train steps and the lr=0 step (required {want_loss}: "
          f"{cfg.epochs * cfg.minibatches} a step); ppo_trunk launches "
          f"{launches['ppo_trunk']} (required {want_trunk}: "
          f"{trunk_step(cfg)} a step) {tag}", flush=True)
    if launches["ppo_gauss_loss"] != want_loss:
        fail(f"ppo_gauss_loss launches {launches['ppo_gauss_loss']} on the "
             f"EV main path, required {want_loss}")
    if launches["ppo_trunk"] != want_trunk:
        fail(f"ppo_trunk launches {launches['ppo_trunk']} on the EV main "
             f"path, required {want_trunk}")
    finish_trainer("EV", env, p, cfg, 21, tag, want_profile)

    # simulation-tier times, after the counts were read
    sim_ms = cuda_ms(lambda: env.fused_rollout(p, sim_batch, STEPS,
                                               generator=sim_gen), 3)
    days = torch.randint(p.n_days, (sim_batch,), generator=gen, device=dev)
    seg_ms = device_ms(lambda: K.ev_segment(p, days, STEPS, seed=12),
                       "ev_segment_launch", 3)
    # the mat-vecs with C the kernel ran on these inputs (it stops an env
    # step's projection at its fixed point and skips C' y where y is 0)
    matvecs = torch.zeros((), dtype=torch.long, device=dev)
    K.ev_segment(p, days, STEPS, seed=12, matvecs=matvecs)
    matvecs = int(matvecs)
    seg_plain_ms = cuda_ms(lambda: K.ev_segment_ref(p, days, STEPS,
                                                    seed=12), 1)
    steps = sim_batch * STEPS
    m2, iters = int(p.proj.C.shape[0]), int(p.proj.iters)
    occ = K.ev_segment_occupancy(m2)
    seg_ctas, seg_warps = occ["ctas"], occ["warps"]
    seg_grid = -(-sim_batch // seg_warps)
    print(f"simulation tier {sim_batch}x{STEPS} projection on: kernel "
          f"{seg_ms:.3f} ms (device) = {steps / seg_ms * 1e3:.0f} "
          f"env-steps/s; plain {seg_plain_ms:.3f} ms = "
          f"{steps / seg_plain_ms * 1e3:.0f} env-steps/s; mean reward "
          f"{ev_mean_reward:.6f}; launches {launches}; {seg_ctas} CTAs of "
          f"{seg_warps} warps resident per SM = {seg_ctas * seg_warps} warps "
          f"(m2 = {m2}), {seg_grid} CTAs = "
          f"{seg_grid / (seg_ctas * sms):.3f} waves on {sms} SMs; mat-vecs "
          f"with C run {matvecs} = {matvecs / steps:.4f} per env step (the "
          f"full loop: {2 * iters + 2}) {tag}", flush=True)
    print(f"simulation tier {sim_batch}x{STEPS}: whole fused_rollout call "
          f"{sim_ms:.3f} ms (CUDA events) = {steps / sim_ms * 1e3:.0f} "
          f"env-steps/s {tag}", flush=True)

    # the loss head at the check's inputs: mu and value read in place, u,
    # logp_old, adv, ret and log_std read once, the gradient written once
    loss_ms = device_ms(lambda: KL.ppo_gauss_loss(*loss_args),
                        "ppo_gauss_loss_launch", 20)
    loss_plain_ms = cuda_ms(lambda: KL.ppo_gauss_loss_ref(*loss_args), 3)
    mu_l, ls_l, value_l, u_l, lp_l, adv_l, ret_l = loss_args[:7]
    loss_bound = bound(2 * nbytes(mu_l, value_l)
                       + nbytes(ls_l, u_l, lp_l, adv_l, ret_l))
    print(f"ppo_gauss_loss {mu_l.shape[0]}x{mu_l.shape[1]}: kernel "
          f"{loss_ms:.4f} ms (device, its three launches); plain "
          f"{loss_plain_ms:.4f} ms; bound {loss_bound[0]:.4f} ms "
          f"({loss_bound[1]}) {tag}", flush=True)
    trunk = trunk_times(trunk_args)
    print(f"ppo_trunk {trunk_args[2].shape[0]}x{trunk_args[2].shape[1]}: "
          f"{json.dumps(trunk)} (device ms of each pass's C entry point; a "
          f"minibatch runs forward_keep twice, backward and backward_obs "
          f"once) {tag}", flush=True)

    # bounds at the main path's shapes (caltech, projection on)
    # mat-vecs with C, each 2 m2 n operations: ev_segment counts those it
    # ran; the policy kernel runs 2 per FISTA iteration, the final C' y and
    # the reward's C p in every step
    step_ops = (2 * iters + 2) * 2 * m2 * n
    seg_bound = bound(nbytes(p.step_table) + sim_batch * (8 + 16 * STEPS),
                      f32_ops=matvecs * 2 * m2 * n)
    pol_bound = bound(
        nbytes(p.step_table, p.moer) + actor_bytes(w)
        + train_envs * (8 + STEPS * (16 + 2 * (D + n))),
        f32_ops=train_envs * STEPS * step_ops,
        bf16_ops=train_envs * STEPS * 2 * (D * HIDDEN + HIDDEN * HIDDEN
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
    dc_kernels, dc_gathers = dc_slice(tag, want_profile)
    kernels[2]["launches"] += dc_gathers     # the gather serves both slices
    kernels += dc_kernels
    kernels += market_slice(tag, want_profile)
    bld_kernels, bld_gathers = building_slice(tag, want_profile)
    kernels[2]["launches"] += bld_gathers
    kernels += bld_kernels
    # one kernel replaces both TPU gathers: the second TPU kernel's entry
    kernels.insert(3, {
        **kernels[2], "name": "hbm_slice_gather",
        "replaces": "sustaingym_tpu/ops/pallas/exog_gather.py:210"})
    kernels.append(ev_lockstep_slice(tag, want_profile))
    kernels.append(
        {"name": "ppo_gauss_loss", "route": "cuda",
         "source": "sustaingym_tpu_torch/ops/cuda/csrc/ppo_loss.cu",
         "replaces": None, "launches": launches["ppo_gauss_loss"],
         "max_abs_err": err["ppo_gauss_loss"], "ms": loss_ms,
         "plain_ms": loss_plain_ms, "bound_ms": loss_bound[0],
         "bound_by": loss_bound[1], "library_ms": None})
    # the trunk's four passes of one minibatch
    mb = {k: sum(trunk[c][k] * n for c, n in TRUNK_MINIBATCH.items())
          for k in ("ms", "plain_ms", "bound_ms")}
    kernels.append(
        {"name": "ppo_trunk", "route": "cuda",
         "source": "sustaingym_tpu_torch/ops/cuda/csrc/ppo_trunk.cu",
         "replaces": None, "launches": launches["ppo_trunk"],
         "max_abs_err": err["ppo_trunk"], **mb, "bound_by": "bytes",
         "library_ms": None})
    ma_slice(tag, want_profile)
    pdhg = next(k for k in kernels if k["name"] == "pdhg_solve_paired")
    pdhg["launches"] += off_policy_slice(tag, want_profile)
    pdhg["max_abs_err"] = max(pdhg["max_abs_err"], mixed_budgets(tag))
    baselines_on_card(tag)
    bf16_gemm_gate(tag)
    fused_update_splits(tag)
    reset_schedule_slice(tag)
    distribution_slice(tag)
    debug_launches = debug_slice(tag)
    examples_slice(tag)
    for path_launches in (debug_launches, profile_slice(tag)):
        for k in kernels:
            # the slice gather's one wrapper serves both TPU gathers' rows
            name = ("episode_slice_gather" if k["name"] == "hbm_slice_gather"
                    else k["name"])
            k["launches"] += path_launches.get(name, 0)
    gmm_fit_slice(tag)
    profile_trainers(tag)
    profile_off_policy(tag)
    if check_jax_tree(jax_tree, jax_files):
        return 1
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
