"""Training CLI of the PyTorch port: PPO, A2C, SAC, double-DQN or
TD3-style DDPG on EVChargingEnv, BuildingEnv, CogenEnv, DataCenterEnv or
ElectricityMarketEnv, or on the multi-agent views of EV charging, building
and cogen.

    python -m sustaingym_tpu_torch.train --env evcharging --eval-every 5
    python -m sustaingym_tpu_torch.train --env evcharging --algo ppo \
        --num-envs 8192 --rollout-len 288 --minibatches 96 --obs-bf16
    python -m sustaingym_tpu_torch.train --env building --num-envs 8192 \
        --rollout-len 288 --minibatches 96 --obs-bf16 --env-kwargs \
        '{"building": "office.htm", "weather": "tucson.epw", "root": "tables",
          "u_wall": [6.299, 3.839, 0.514, 0.228, 4.488, 0.319, 2.615]}'
    python -m sustaingym_tpu_torch.train --env cogen --num-envs 8192 \
        --rollout-len 96 --minibatches 24
    python -m sustaingym_tpu_torch.train --env datacenter --num-envs 4096 \
        --rollout-len 672 --minibatches 84
    python -m sustaingym_tpu_torch.train --env electricitymarket \
        --num-envs 4096 --rollout-len 288 --minibatches 36
    python -m sustaingym_tpu_torch.train --env electricitymarket \
        --env-kwargs '{"discrete": true}' --algo a2c --num-envs 4096 \
        --rollout-len 288 --minibatches 36
    python -m sustaingym_tpu_torch.train --env evcharging-multiagent \
        --num-envs 512 --rollout-len 288 --minibatches 36 --obs-bf16 \
        --env-kwargs '{"project_action": false, "periods_delay": 2}'
    python -m sustaingym_tpu_torch.train --env cogen-multiagent \
        --num-envs 4096 --rollout-len 96 --minibatches 24
    python -m sustaingym_tpu_torch.train --env evcharging --algo sac \
        --num-envs 2048 --env-kwargs '{"project_action": false}'
    python -m sustaingym_tpu_torch.train --env electricitymarket \
        --algo dqn --num-envs 4096 --rollout-len 32 \
        --env-kwargs '{"discrete": true}'
    python -m sustaingym_tpu_torch.train --env electricitymarket \
        --algo ddpg --num-envs 4096 --rollout-len 32

``--rollout-len`` (default 64, as the JAX CLI's) takes any length: at the
env's episode length each rollout is one whole episode per env (the fused
or episodic path), at any other the generic rollout carries the envs
across train steps (``parallel/ppo.py``, which also lists the multi-agent
paths). ``--algo sac|dqn|ddpg`` train off-policy over the on-device
replay ring (``parallel/offpolicy.py``), ``--rollout-len`` steps into the
ring and 16 gradient updates a train step, the JAX CLI's configurations
(DQN's reward scale 1e-4 on cogen and cogen-multiagent, as PPO's).

Writes per-iteration metrics to ``<log-dir>/train_results.csv``, saves the
whole carry (every network, target and optimizer state, SAC's
``log_alpha``, the env states and obs, the off-policy ring, ``written``
and DQN's ``iter``) and the generator state with ``torch.save`` every
``--save-every`` iterations (``<log-dir>/checkpoints/step_<i>.pt``), and
resumes from the newest checkpoint of ``--restore``, which must match the
trainer's carry entry for entry. ``--eval-every N`` runs the deterministic
actor (``train_step.actor_fn``: mean action, most likely bins, greedy Q
action) over one episode of
``--eval-episodes`` envs every N iterations (``core.batch_rollout``, its
episode loop replayed from one CUDA graph across evaluations on the
card), appends the mean return (of a multi-agent view: the agents'
rewards summed) and the mean of every float info field to
``<log-dir>/eval_results.csv``, and saves a new best to
``<log-dir>/best_model/step_<i>.pt``; a resumed run reads its best from
the CSV, whose header must match. ``--profile`` traces iterations 2-4 of
the run (clamped into it; "skipped" with fewer than 2) with
``torch.profiler`` into ``<log-dir>/profile/trace_rank<r>.json``, one
Chrome trace a rank, each iteration a ``record_function`` span named
``iteration <i>``, under a ``core.trace`` recording: the trace also holds
the program's spans (``ppo.step``, ``ppo.rollout``, ``ppo.score``,
``ppo.update``, ``graphs.replay``, ...), and the recording's snapshot
(each span's host and device ms, self time, parent and step; the
``graphs.replays.*`` and ``host_syncs.*`` counters; each kernel's
launches) is written beside the trace as
``<log-dir>/profile/spans_rank<r>.json``. Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given; asking
for ``cuda`` without a CUDA device is an error. On the card each train
step replays CUDA graphs captured at the first one (``parallel/ppo.py``),
after any restore; the first iteration's time includes the captures.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys
import time

# the env carry: replaced on restore (its tensors may alias one another,
# as a reset's); every other tensor is copied into in place
ENV_CARRY = ("env_states", "obs")
# the carry entries a dp mesh splits, and their env axis (the off-policy
# ring is (capacity, num_envs, ...)); checkpoints hold the whole batch
DP_AXES = {"env_states": 0, "obs": 0, "buffer": 1}


def _kind(value) -> str:
    """How a carry entry is saved: a module's or an optimizer's state
    dict, or the tensor leaves of anything else."""
    import torch
    from torch import nn
    if isinstance(value, nn.Module):
        return "module"
    if isinstance(value, torch.optim.Optimizer):
        return "optimizer"
    return "tensors"


def _mp_axes(carry: dict) -> dict:
    """{parameter: (state-dict name, axis)} of every mp-split parameter
    of the carry's networks."""
    from torch import nn

    from sustaingym_tpu_torch.parallel.ppo import mp_param_axes
    return {p: ax for v in carry.values() if isinstance(v, nn.Module)
            for p, ax in mp_param_axes(v).items()}


def _opt_slots(opt, axes: dict) -> dict:
    """{index in ``opt``'s state dict: axis} of its mp-split parameters."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return {i: axes[p][1] for i, p in enumerate(params) if p in axes}


def _whole(k: str, v, kind: str, axes: dict, mesh):
    """Carry entry ``k`` in the one-rank format: mp shards and dp rows
    gathered (every rank calls it: the gathers are collectives)."""
    import torch
    import torch.distributed as dist

    from sustaingym_tpu_torch.core.graph import tree_leaves
    from sustaingym_tpu_torch.parallel.ppo import mp_param_axes
    if kind == "module":
        state = dict(v.state_dict())
        for name, axis in mp_param_axes(v).values():
            state[name] = mesh.unshard(state[name], axis)
        return state
    if kind == "optimizer":
        state = v.state_dict()
        for i, axis in _opt_slots(v, axes).items():
            state["state"][i] = {
                s: (mesh.unshard(x, axis) if s != "step" else x)
                for s, x in state["state"][i].items()}
        return state
    leaves = [x.detach() for x in tree_leaves(v)]
    if mesh is not None and mesh.dp > 1 and k in DP_AXES:
        whole = []
        for x in leaves:
            parts = [torch.empty_like(x) for _ in range(mesh.dp)]
            dist.all_gather(parts, x.contiguous(), group=mesh.dp_group)
            whole.append(torch.cat(parts, DP_AXES[k]))
        leaves = whole
    return [x.cpu() for x in leaves]


def save_checkpoint(path: str, carry: dict, generator, step: int,
                    mesh=None) -> None:
    """Saves ``carry`` and ``generator`` to ``path/step_<step>.pt``. With
    a ``mesh`` every rank calls it: the mp shards and the dp ranks' envs
    and ring columns are gathered into the one-rank format, which rank 0
    writes, so ``--restore`` works at any mesh."""
    import torch
    kinds = {k: _kind(v) for k, v in carry.items()}
    axes = _mp_axes(carry) if mesh is not None else {}
    payload = {k: _whole(k, v, kinds[k], axes, mesh)
               for k, v in carry.items()}
    if mesh is not None and mesh.rank != 0:
        return
    os.makedirs(path, exist_ok=True)
    torch.save({"iteration": step, "generator": generator.get_state(),
                "carry": payload, "kinds": kinds},
               os.path.join(path, f"step_{step}.pt"))


def _shard_saved(k: str, saved, kind: str, value, axes: dict, mesh):
    """A one-rank checkpoint's entry cut to this rank's part of
    ``mesh``."""
    from sustaingym_tpu_torch.parallel.ppo import mp_param_axes
    if mesh is None:
        return saved
    if kind == "module":
        saved = dict(saved)
        for name, axis in mp_param_axes(value).values():
            saved[name] = mesh.model_shard(saved[name], axis)
        return saved
    if kind == "optimizer":
        for i, axis in _opt_slots(value, axes).items():
            saved["state"][i] = {
                s: (mesh.model_shard(x, axis) if s != "step" else x)
                for s, x in saved["state"][i].items()}
        return saved
    if k in DP_AXES and mesh.dp > 1:
        axis = DP_AXES[k]
        rows = [mesh.data_slice(x.shape[axis]) for x in saved]
        return [x.narrow(axis, r.start, r.stop - r.start).clone()
                for x, r in zip(saved, rows)]
    return saved


def restore_checkpoint(path: str, carry: dict, generator,
                       mesh=None) -> int:
    """Loads the newest ``step_<i>.pt`` of ``path`` into ``carry`` and
    ``generator``; returns its iteration. A checkpoint whose entries,
    kinds or tensor shapes differ from ``carry``'s is refused. With a
    ``mesh`` each rank takes its part of the one-rank checkpoint."""
    import torch

    from sustaingym_tpu_torch.core import tree_map
    from sustaingym_tpu_torch.core.graph import tree_leaves
    steps = sorted(int(f[5:-3]) for f in os.listdir(path)
                   if f.startswith("step_") and f.endswith(".pt"))
    if not steps:
        raise SystemExit(f"no step_<i>.pt checkpoint in {path}")
    ckpt = torch.load(os.path.join(path, f"step_{steps[-1]}.pt"),
                      map_location="cpu", weights_only=True)
    kinds = {k: _kind(v) for k, v in carry.items()}
    if ckpt.get("kinds") != kinds:
        raise SystemExit(f"{path}: the checkpoint's carry "
                         f"{ckpt.get('kinds')} does not match this "
                         f"trainer's {kinds}")
    axes = _mp_axes(carry) if mesh is not None else {}
    for k, kind in kinds.items():
        saved = _shard_saved(k, ckpt["carry"][k], kind, carry[k], axes, mesh)
        if kind != "tensors":
            try:
                carry[k].load_state_dict(saved)
            except (RuntimeError, ValueError, KeyError) as e:
                raise SystemExit(f"{path}: the checkpoint's {k} does not "
                                 f"match this trainer's: {e}") from e
            continue
        leaves = tree_leaves(carry[k])
        if [(x.shape, x.dtype) for x in saved] != [(x.shape, x.dtype)
                                                   for x in leaves]:
            raise SystemExit(f"{path}: the checkpoint's {k} does not match "
                             f"this trainer's")
        if k in ENV_CARRY:
            it = iter(saved)
            carry[k] = tree_map(lambda x: next(it).to(x.device), carry[k])
        else:
            with torch.no_grad():
                for dst, src in zip(leaves, saved):
                    dst.copy_(src)
    generator.set_state(ckpt["generator"])
    return int(ckpt["iteration"])


def read_best(csv_path: str) -> float:
    """The best ``mean_return`` of an existing ``eval_results.csv``."""
    best = float("-inf")
    if os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                try:
                    best = max(best, float(row["mean_return"]))
                except (KeyError, ValueError):
                    pass
    return best


def make_evaluator(env, env_params, train_step, episodes: int, seed: int,
                   capture: bool = True):
    """``evaluate(nets, i) -> row``: the deterministic actor
    (``train_step.actor_fn`` of ``nets``, the carry's
    ``train_step.actor_key``) over one
    episode of ``episodes`` envs (``core.batch_rollout``), reset days
    drawn from a generator seeded by ``seed`` and ``i``. The row holds
    ``mean_return`` and the mean of every float info field. One
    ``Graphs`` serves every evaluation, so on the card each one after the
    first replays its episode loop (the graph reads the policy's weights
    in place). ``capture`` False runs the episodes eagerly (an mp split's
    actor holds a collective)."""
    import torch
    from sustaingym_tpu_torch.core import batch_rollout
    from sustaingym_tpu_torch.core.graph import Graphs

    ep_len = env.episode_steps(env_params)
    device = env_params.device
    graphs = Graphs(device) if capture else None
    gen = torch.Generator(device=device)
    actor = train_step.actor_fn

    def eval_policy(nets, obs, generator):
        return actor(nets, obs)

    @torch.no_grad()
    def evaluate(nets, i: int) -> dict:
        gen.manual_seed(seed + 500_000 + i)
        traj = batch_rollout(env, env_params, eval_policy, nets, gen,
                             episodes, ep_len, graphs=graphs)
        reward = traj.reward
        if reward.ndim == 3:            # a view's agents: their sum
            reward = reward.sum(-1)
        row = {"iteration": i,
               "mean_return": float(reward.sum(0).mean())}
        row.update({k: float(v.float().mean()) for k, v in traj.info.items()
                    if torch.is_tensor(v) and v.is_floating_point()})
        return row

    evaluate.graphs = graphs
    return evaluate


def start_profile(device):
    """A started ``torch.profiler`` of the CPU and, on the card, CUDA
    activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, rec, log_dir: str, rank: int) -> str:
    """Stops ``prof`` once the card is idle and writes its Chrome trace to
    ``<log_dir>/profile/trace_rank<rank>.json`` and the snapshot of the
    trace recording ``rec`` to ``spans_rank<rank>.json`` beside it;
    returns the trace's path."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(out, f"spans_rank{rank}.json"), "w") as f:
        json.dump(rec.snapshot(), f)
    return path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="evcharging",
                        choices=["evcharging", "building", "cogen",
                                 "datacenter", "electricitymarket",
                                 "evcharging-multiagent",
                                 "building-multiagent", "cogen-multiagent"])
    parser.add_argument("--env-kwargs", default=None,
                        help="JSON dict forwarded to make(env, **kwargs), "
                             "e.g. '{\"site\": \"jpl\"}'; building's "
                             "default reads the raw OfficeSmall/Tucson "
                             "tables")
    parser.add_argument("--algo", default="ppo",
                        choices=["ppo", "a2c", "sac", "dqn", "ddpg"],
                        help="ppo/a2c (on-policy), or sac, dqn (double-DQN "
                             "for discrete envs), ddpg (TD3-style): "
                             "off-policy over the on-device replay ring")
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda (default) or cpu")
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--rollout-len", type=int, default=64,
                        help="steps a rollout; at the episode length "
                             "(evcharging 288, building 288, cogen 96, "
                             "datacenter 672, electricitymarket 288) each "
                             "rollout is one whole episode per env, at any "
                             "other the envs carry over between rollouts")
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--minibatches", type=int, default=8)
    parser.add_argument("--reward-scale", type=float, default=None,
                        help="multiplies rewards before GAE (default 1e-4 "
                             "for cogen and cogen-multiagent, 1.0 "
                             "otherwise)")
    parser.add_argument("--obs-bf16", action="store_true",
                        help="store observations in bfloat16; with it and "
                             "whole-episode rollouts, evcharging and "
                             "building train on the policy-in-kernel "
                             "rollout, whose kernel writes a bf16 learner "
                             "block")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="evaluate the deterministic policy every N "
                             "iterations (0 = off): eval_results.csv and "
                             "best_model/ in the log dir")
    parser.add_argument("--eval-episodes", type=int, default=5,
                        help="envs (one episode each) an evaluation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", default="runs/default")
    parser.add_argument("--save-every", type=int, default=10)
    parser.add_argument("--restore", default=None,
                        help="checkpoint dir to resume from")
    parser.add_argument("--mesh", type=int, default=0,
                        help="train over N ranks (0 = one process): the "
                             "env batch split over N / mp data-parallel "
                             "ranks; under torchrun WORLD_SIZE must be N, "
                             "launched alone it spawns its N ranks (gloo "
                             "where they share a card or run on the CPU)")
    parser.add_argument("--mp", type=int, default=1,
                        help="tensor-parallel width within the mesh: the "
                             "PPO MLP's hidden split over mp ranks")
    parser.add_argument("--profile", action="store_true",
                        help="trace iterations 2-4 (after the first train "
                             "step, which captures the CUDA graphs) with "
                             "torch.profiler, CPU and CUDA activities, into "
                             "<log-dir>/profile/trace_rank<r>.json (a "
                             "Chrome trace a rank, holding the program's "
                             "spans); view with chrome://tracing or "
                             "Perfetto; the spans' snapshot in "
                             "spans_rank<r>.json beside it")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from sustaingym_tpu_torch.core import trace
    from sustaingym_tpu_torch.parallel import (init_distributed, make_mesh,
                                               spawn)

    if args.mesh > 1 and not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            if int(os.environ["WORLD_SIZE"]) != args.mesh:
                raise SystemExit(f"--mesh {args.mesh} under torchrun with "
                                 f"WORLD_SIZE={os.environ['WORLD_SIZE']}")
            init_distributed(device=args.device)
        else:
            # launched alone: one process a rank, each running this main
            # (by its import path: ``-m`` runs this file as __main__)
            from sustaingym_tpu_torch.train import main as entry
            spawn(entry, args.mesh,
                  (sys.argv[1:] if argv is None else list(argv),),
                  device=args.device, timeout=24 * 3600.0)
            return
    mesh = None
    if args.mesh:
        mesh = make_mesh(args.mesh, mp=args.mp, device=args.device)
    rank0 = mesh is None or mesh.rank == 0

    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.parallel import (DDPGConfig, DQNConfig,
                                               PPOConfig, SACConfig,
                                               make_ddpg_train_step,
                                               make_dqn_train_step,
                                               make_sac_train_step,
                                               make_train_step)

    device = torch.device(args.device) if mesh is None else mesh.device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        if device.index is not None:
            torch.cuda.set_device(device)
        # full-f32 matmuls for the projection and the learner's scoring
        torch.backends.cuda.matmul.allow_tf32 = False
    env_kwargs = json.loads(args.env_kwargs) if args.env_kwargs else {}
    env, env_params = make(args.env, device=device, **env_kwargs)
    reward_scale = args.reward_scale
    if reward_scale is None:
        reward_scale = 1e-4 if args.env.startswith("cogen") else 1.0
    common = dict(num_envs=args.num_envs, rollout_len=args.rollout_len,
                  hidden=args.hidden, lr=args.lr, gamma=args.gamma)
    if args.algo == "sac":
        cfg = SACConfig(**common)
        init_state, train_step = make_sac_train_step(env, env_params, cfg,
                                                     mesh=mesh)
    elif args.algo == "dqn":
        cfg = DQNConfig(reward_scale=reward_scale, **common)
        init_state, train_step = make_dqn_train_step(env, env_params, cfg,
                                                     mesh=mesh)
    elif args.algo == "ddpg":
        cfg = DDPGConfig(**common)
        init_state, train_step = make_ddpg_train_step(env, env_params, cfg,
                                                      mesh=mesh)
    else:
        cfg = PPOConfig(epochs=args.epochs, minibatches=args.minibatches,
                        reward_scale=reward_scale, obs_bf16=args.obs_bf16,
                        algo=args.algo, **common)
        init_state, train_step = make_train_step(env, env_params, cfg,
                                                 mesh=mesh)
    if mesh is not None and rank0:
        print(f"mesh: dp={mesh.dp} mp={mesh.mp} on {device}", flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    carry = init_state(gen)
    start_iter = 0
    if args.restore:
        start_iter = restore_checkpoint(args.restore, carry, gen, mesh)
        if rank0:
            print(f"restored checkpoint at iteration {start_iter}")

    csv_path = os.path.join(args.log_dir, "train_results.csv")
    ckpt_dir = os.path.join(args.log_dir, "checkpoints")
    if rank0:
        os.makedirs(args.log_dir, exist_ok=True)
    steps_per_iter = cfg.num_envs * train_step.rollout_len
    evaluate = (make_evaluator(env, env_params, train_step,
                               args.eval_episodes, args.seed,
                               capture=mesh is None or mesh.mp == 1)
                if args.eval_every else None)
    eval_csv = os.path.join(args.log_dir, "eval_results.csv")
    best = read_best(eval_csv) if rank0 else float("-inf")
    eval_writer = None

    def run_eval(i: int, eval_f):
        nonlocal best, eval_writer
        # every rank evaluates (an mp split's actor holds a collective);
        # rank 0's return and best decide, so every rank saves together
        row = evaluate(carry[train_step.actor_key], i)
        new_best = row["mean_return"] > best
        if mesh is not None:
            pack = torch.tensor([row["mean_return"], float(new_best)],
                                dtype=torch.float64, device=device)
            dist.broadcast(pack, 0)
            row["mean_return"], new_best = float(pack[0]), bool(pack[1])
        if new_best:
            best = row["mean_return"]
            save_checkpoint(os.path.join(args.log_dir, "best_model"), carry,
                            gen, i, mesh)
        if not rank0:
            return
        if eval_writer is None:
            if eval_f.tell() > 0:
                with open(eval_csv, newline="") as prev:
                    old = next(csv.reader(prev), None)
                if old is not None and old != list(row):
                    raise SystemExit(
                        f"{eval_csv} exists with columns {old} but this run "
                        f"writes {list(row)}; use a fresh --log-dir")
            eval_writer = csv.DictWriter(eval_f, fieldnames=list(row))
            if eval_f.tell() == 0:
                eval_writer.writeheader()
        eval_writer.writerow(row)
        eval_f.flush()
        marker = " (new best, saved)" if new_best else ""
        print(f"eval @ iter {i}: return={row['mean_return']:.4f}{marker}",
              flush=True)

    def opened(path):
        return (open(path, "a", newline="") if rank0
                else contextlib.nullcontext())

    # trace iterations 2-4 (replays of the graphs the first one captured),
    # the span clamped into this run, so the trace closes before the
    # final checkpoint
    span = (start_iter + 1, min(start_iter + 3,
                                start_iter + args.iterations - 1))
    profiling = args.profile and span[0] <= span[1]
    if args.profile and not profiling and rank0:
        print("profiler: skipped (needs --iterations >= 2)")
    prof = rec = None
    spans = contextlib.ExitStack()

    with spans, opened(csv_path) as f, \
            (opened(eval_csv) if evaluate
             else contextlib.nullcontext()) as eval_f:
        writer = None
        for i in range(start_iter, start_iter + args.iterations):
            if profiling and i == span[0]:
                prof = start_profile(device)
                rec = spans.enter_context(trace.recording())
            t0 = time.perf_counter()
            with (torch.profiler.record_function(f"iteration {i}")
                  if prof is not None else contextlib.nullcontext()):
                carry, metrics = train_step(carry, gen)
                row = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            if prof is not None and i == span[1]:
                path = stop_profile(prof, rec, args.log_dir,
                                    0 if mesh is None else mesh.rank)
                spans.close()
                prof = None
                print(f"profiler trace of iterations {span[0]}-{span[1]} "
                      f"in {path}", flush=True)
            row.update(iteration=i, seconds=dt,
                       env_steps_per_s=steps_per_iter / dt)
            if rank0:
                if writer is None:
                    writer = csv.DictWriter(f, fieldnames=list(row))
                    if f.tell() == 0:
                        writer.writeheader()
                writer.writerow(row)
                f.flush()
                print(f"iter {i}: reward={row['mean_reward']:.4f} "
                      f"({row['env_steps_per_s']:.0f} env-steps/s on "
                      f"{device.type})", flush=True)
            if (i + 1) % args.save_every == 0:
                save_checkpoint(ckpt_dir, carry, gen, i + 1, mesh)
            if evaluate is not None and (i + 1) % args.eval_every == 0:
                run_eval(i + 1, eval_f)
    train_step.check(carry)
    save_checkpoint(ckpt_dir, carry, gen, start_iter + args.iterations, mesh)
    if rank0:
        print(f"done; logs in {csv_path}")


if __name__ == "__main__":
    main()
