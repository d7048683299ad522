"""Rank-scaling benchmark: a learner's train step over a (dp, mp) mesh of
processes, the counterpart of ``sustaingym_tpu/bench/scaling.py``.

Each rank is one process of a ``torch.distributed`` group
(``parallel.distributed.spawn``): the env batch sharded over dp, the PPO
MLP over mp (``parallel/mesh.py``), gradients and metrics all-reduced.
It prints env-steps/s at each rank count and the scaling efficiency
against one rank, as JSON lines in the JAX bench's shape, plus how many
cards the ranks shared:

    python -m sustaingym_tpu_torch.bench_scaling --devices 1 2 \\
        --env evcharging --num-envs 1024 --rollout-len 32
    python -m sustaingym_tpu_torch.bench_scaling --device cpu --devices 1 2 4

``--devices`` counts ranks. NCCL needs a card a rank; where ranks share a
card (or run on the CPU) the group is gloo, and the efficiency measures
how the ranks share that card or the host's cores, not how the learner
scales across cards. ``--equivalence`` also runs one train step at one
rank and at the largest count from the same seed and prints the largest
metric difference (the scaling artifact's correctness signal).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import tempfile
import time

__all__ = ["rank_run", "measure", "equivalence", "main"]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_run(env_name: str, algo: str, cfg_kwargs: dict, mp: int,
             steps: int, seed: int, device: str, make_kwargs: dict) -> dict:
    """One rank's part (run by :func:`parallel.distributed.spawn`): the
    mesh of the whole group, the trainer on this rank's shard, one
    warm-up step (the captures) and ``steps`` timed steps. Returns the
    metrics of every step, the timed seconds, the parameters' and the
    generator's SHA-256 (the parameters gathered to the one-rank format),
    the kernel launches, the rank's wall seconds, the peak device memory
    and the card's name."""
    import torch

    from .bench import make_env
    from .core.graph import counted_wrappers
    t_start = time.perf_counter()
    from .parallel import (PPOConfig, SACConfig, make_mesh,
                           make_sac_train_step, make_train_step)
    from .parallel.ppo import unsharded_state

    mesh = make_mesh(mp=mp, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tables:
        env, params = make_env(env_name, dev, tables, **make_kwargs)
    if algo == "sac":
        cfg = SACConfig(**cfg_kwargs)
        init_state, train_step = make_sac_train_step(env, params, cfg,
                                                     mesh=mesh)
    else:
        cfg = PPOConfig(**cfg_kwargs)
        init_state, train_step = make_train_step(env, params, cfg,
                                                 mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    carry = init_state(gen)
    for w in counted_wrappers():
        w.launches = 0
    history = []
    carry, m = train_step(carry, gen)
    history.append({k: float(v) for k, v in m.items()})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        carry, m = train_step(carry, gen)
        history.append({k: float(v) for k, v in m.items()})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    train_step.check(carry)
    if algo == "sac":
        nets = [carry["actor"], carry["critics"], carry["targets"]]
        weights = [x for n in nets for x in n.state_dict().values()]
    else:
        weights = list(unsharded_state(carry["policy"], mesh).values())
    return {"rank": mesh.rank, "metrics": history, "seconds": seconds,
            "wall": time.perf_counter() - t_start,
            "params": _digest(weights),
            "generator": hashlib.sha256(
                gen.get_state().numpy().tobytes()).hexdigest(),
            "path": getattr(train_step, "path", "off-policy"),
            "launches": {w.__name__: w.launches for w in counted_wrappers()
                         if w.launches},
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None),
            "card": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu")}


def _config(algo: str, num_envs: int, rollout_len: int, hidden: int
            ) -> dict:
    cfg = {"num_envs": num_envs, "rollout_len": rollout_len,
           "hidden": hidden}
    if algo == "ppo":
        cfg.update(epochs=1, minibatches=2)
    return cfg


def run_ranks(n: int, env_name: str, algo: str, cfg_kwargs: dict,
              mp: int = 1, steps: int = 1, seed: int = 0, device="cuda",
              make_kwargs: dict | None = None) -> list[dict]:
    """:func:`rank_run` on each of ``n`` spawned ranks (one rank in this
    process, outside any process group)."""
    import torch.distributed as dist

    from .parallel.distributed import spawn
    args = (env_name, algo, cfg_kwargs, mp, steps, seed, device,
            make_kwargs or {})
    if n == 1 and not dist.is_initialized():
        return [rank_run(*args)]
    return spawn(rank_run, n, args, device=device)


def measure(n_devices: int, env_name: str, num_envs: int, rollout_len: int,
            iters: int, mp: int = 1, algo: str = "ppo", hidden: int = 256,
            device="cuda") -> dict:
    """Env-steps/s of ``iters`` train steps of the global batch
    ``num_envs`` on ``n_devices`` ranks (after one warm-up step), the
    slowest rank's time; ``cards`` is the number of cards the ranks ran
    on (0 on the CPU)."""
    ranks = run_ranks(n_devices, env_name, algo,
                      _config(algo, num_envs, rollout_len, hidden), mp=mp,
                      steps=iters, device=device)
    dt = max(r["seconds"] for r in ranks)
    cards = 0 if ranks[0]["card"] == "cpu" else min(
        n_devices, _card_count())
    return {"devices": n_devices, "env_steps_per_s":
            num_envs * rollout_len * iters / dt, "seconds": dt,
            "mp": mp, "cards": cards, "card": ranks[0]["card"]}


def _card_count() -> int:
    import torch
    return torch.cuda.device_count()


def equivalence(n_devices: int, env_name: str, num_envs: int,
                rollout_len: int, mp: int = 1, steps: int = 1,
                algo: str = "ppo", hidden: int = 64, device="cuda",
                make_kwargs: dict | None = None) -> dict:
    """``steps`` train steps from the same seed at one rank and at
    ``n_devices`` ranks (the same global batch): the largest difference
    over every step's metrics, and whether the ranks of the larger run
    hold equal parameters and generator states."""
    cfg = _config(algo, num_envs, rollout_len, hidden)
    one = run_ranks(1, env_name, algo, cfg, steps=steps - 1, device=device,
                    make_kwargs=make_kwargs)[0]
    many = run_ranks(n_devices, env_name, algo, cfg, mp=mp, steps=steps - 1,
                     device=device, make_kwargs=make_kwargs)
    diff = max(abs(a[k] - b[k]) for r in many
               for a, b in zip(one["metrics"], r["metrics"]) for k in a)
    return {"dp1_vs_dpN_metrics_max_abs_diff": diff, "devices": n_devices,
            "mp": mp,
            "params_equal_across_ranks": len({r["params"] for r in many})
            == 1,
            "generator_equal_across_ranks": len({r["generator"]
                                                 for r in many}) == 1,
            "generator_equal_to_one_rank": many[0]["generator"]
            == one["generator"],
            "metrics_dp1": one["metrics"], "metrics_dpN": many[0]["metrics"]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="building")
    parser.add_argument("--devices", type=int, nargs="+", default=[1, 2],
                        help="rank counts to sweep")
    parser.add_argument("--num-envs", type=int, default=512,
                        help="env batch PER RANK (weak scaling); with "
                             "--strong the fixed TOTAL batch")
    parser.add_argument("--strong", action="store_true",
                        help="strong scaling: hold the total batch fixed")
    parser.add_argument("--rollout-len", type=int, default=32)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--mp", type=int, default=1)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--algo", default="ppo", choices=["ppo", "sac"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the card; ranks share it "
                             "where there are fewer cards) or cpu")
    parser.add_argument("--equivalence", action="store_true",
                        help="also one train step at 1 rank and at the "
                             "largest count from the same seed, and the "
                             "largest metric difference")
    args = parser.parse_args(argv)

    results = []
    for n in args.devices:
        total = args.num_envs if args.strong else args.num_envs * n
        r = measure(n, args.env, total, args.rollout_len, args.iters,
                    mp=args.mp, algo=args.algo, hidden=args.hidden,
                    device=args.device)
        r["algo"] = args.algo
        r["scaling"] = "strong" if args.strong else "weak"
        results.append(r)
        print(json.dumps(r), flush=True)
    if any(r["cards"] < r["devices"] for r in results):
        print(json.dumps({"note": "ranks shared cards (or the CPU's "
                          "cores): the efficiency below measures that "
                          "sharing, not scaling across cards"}))
    if len(results) > 1:
        base = results[0]
        for r in results[1:]:
            ratio = r["devices"] / base["devices"]
            if args.strong:
                eff = r["env_steps_per_s"] / (base["env_steps_per_s"]
                                              * ratio)
            else:
                eff = r["env_steps_per_s"] / (ratio
                                              * base["env_steps_per_s"])
            print(json.dumps({"devices": r["devices"], "algo": args.algo,
                              "scaling": r["scaling"], "cards": r["cards"],
                              "scaling_efficiency": eff}))
    if args.equivalence:
        n_eq = max(args.devices)
        eq = equivalence(n_eq, args.env,
                         args.num_envs if args.strong
                         else args.num_envs * n_eq,
                         args.rollout_len, mp=args.mp, algo=args.algo,
                         hidden=args.hidden, device=args.device)
        print(json.dumps(eq))


if __name__ == "__main__":
    main()
