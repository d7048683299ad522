"""Training CLI of the PyTorch port: PPO or A2C on EVChargingEnv,
BuildingEnv, CogenEnv, DataCenterEnv or ElectricityMarketEnv.

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
        --minibatches 36

Writes per-iteration metrics to ``<log-dir>/train_results.csv``, saves the
policy, optimizer and generator state with ``torch.save`` every
``--save-every`` iterations (``<log-dir>/checkpoints/step_<i>.pt``), and
resumes from the newest checkpoint of ``--restore``. Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given; asking
for ``cuda`` without a CUDA device is an error. On the card each train
step replays CUDA graphs captured at the first one (``parallel/ppo.py``),
after any restore; the first iteration's time includes the captures.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time


def save_checkpoint(path: str, carry: dict, generator, step: int) -> None:
    import torch
    os.makedirs(path, exist_ok=True)
    torch.save({"iteration": step,
                "policy": carry["policy"].state_dict(),
                "opt": carry["opt"].state_dict(),
                "generator": generator.get_state()},
               os.path.join(path, f"step_{step}.pt"))


def restore_checkpoint(path: str, carry: dict, generator) -> int:
    """Loads the newest ``step_<i>.pt`` of ``path`` into ``carry`` and
    ``generator``; returns its iteration."""
    import torch
    steps = sorted(int(f[5:-3]) for f in os.listdir(path)
                   if f.startswith("step_") and f.endswith(".pt"))
    if not steps:
        raise SystemExit(f"no step_<i>.pt checkpoint in {path}")
    ckpt = torch.load(os.path.join(path, f"step_{steps[-1]}.pt"),
                      map_location="cpu", weights_only=True)
    carry["policy"].load_state_dict(ckpt["policy"])
    carry["opt"].load_state_dict(ckpt["opt"])
    generator.set_state(ckpt["generator"])
    return int(ckpt["iteration"])


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="evcharging",
                        choices=["evcharging", "building", "cogen",
                                 "datacenter", "electricitymarket"])
    parser.add_argument("--env-kwargs", default=None,
                        help="JSON dict forwarded to make(env, **kwargs), "
                             "e.g. '{\"site\": \"jpl\"}'; building's "
                             "default reads the raw OfficeSmall/Tucson "
                             "tables")
    parser.add_argument("--algo", default="ppo", choices=["ppo", "a2c"])
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda (default) or cpu")
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--rollout-len", type=int, default=None,
                        help="must equal the episode length (evcharging "
                             "288, building 288, cogen 96, datacenter 672, "
                             "electricitymarket 288; the default): each "
                             "rollout is one whole episode per env")
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--minibatches", type=int, default=8)
    parser.add_argument("--reward-scale", type=float, default=None,
                        help="multiplies rewards before GAE (default 1e-4 "
                             "for cogen, 1.0 otherwise)")
    parser.add_argument("--obs-bf16", action="store_true",
                        help="store observations in bfloat16 (evcharging "
                             "needs it; with it, evcharging and building "
                             "train on the policy-in-kernel rollout, whose "
                             "kernel writes a bf16 learner block)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", default="runs/default")
    parser.add_argument("--save-every", type=int, default=10)
    parser.add_argument("--restore", default=None,
                        help="checkpoint dir to resume from")
    args = parser.parse_args(argv)

    import torch

    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        # full-f32 matmuls for the projection and the learner's scoring
        torch.backends.cuda.matmul.allow_tf32 = False
    env_kwargs = json.loads(args.env_kwargs) if args.env_kwargs else {}
    env, env_params = make(args.env, device=device, **env_kwargs)
    ep_len = env.episode_steps(env_params)
    if args.rollout_len not in (None, ep_len):
        raise SystemExit(f"--rollout-len must equal the episode length "
                         f"({ep_len}): each rollout is one whole episode")
    reward_scale = args.reward_scale
    if reward_scale is None:
        reward_scale = 1e-4 if args.env == "cogen" else 1.0
    cfg = PPOConfig(num_envs=args.num_envs, hidden=args.hidden, lr=args.lr,
                    gamma=args.gamma, epochs=args.epochs,
                    minibatches=args.minibatches, reward_scale=reward_scale,
                    obs_bf16=args.obs_bf16, algo=args.algo)
    init_state, train_step = make_train_step(env, env_params, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    carry = init_state(gen)
    start_iter = 0
    if args.restore:
        start_iter = restore_checkpoint(args.restore, carry, gen)
        print(f"restored checkpoint at iteration {start_iter}")

    os.makedirs(args.log_dir, exist_ok=True)
    csv_path = os.path.join(args.log_dir, "train_results.csv")
    ckpt_dir = os.path.join(args.log_dir, "checkpoints")
    steps_per_iter = cfg.num_envs * ep_len
    with open(csv_path, "a", newline="") as f:
        writer = None
        for i in range(start_iter, start_iter + args.iterations):
            t0 = time.perf_counter()
            carry, metrics = train_step(carry, gen)
            row = {k: float(v) for k, v in metrics.items()}  # synchronises
            dt = time.perf_counter() - t0
            row.update(iteration=i, seconds=dt,
                       env_steps_per_s=steps_per_iter / dt)
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
                save_checkpoint(ckpt_dir, carry, gen, i + 1)
    save_checkpoint(ckpt_dir, carry, gen, start_iter + args.iterations)
    print(f"done; logs in {csv_path}")


if __name__ == "__main__":
    main()
