"""One train step of every sharded learner on an n-rank mesh: the
counterpart of ``__graft_entry__.py::dryrun_multichip``.

    python -m sustaingym_tpu_torch.dryrun 4            # on the card
    python -m sustaingym_tpu_torch.dryrun 4 --device cpu

Spawns ``n`` ranks (``parallel.distributed.spawn``: gloo where they share
a card or run on the CPU) on one (n / mp, mp) mesh, mp = 2 where n is
even, and runs one train step of each case at tiny shapes: PPO and SAC on
the building (the synthetic tables), PPO on the multi-agent EV view on
the generic path and on the uniform-obs path, PPO on the multi-agent
cogen view with stacked per-agent policies (their hidden split over mp),
and DQN and DDPG on the market. Every rank must report the same metrics
(they are all-reduced); rank 0's are printed.
"""
from __future__ import annotations

import argparse
import math
import tempfile

__all__ = ["dryrun_multichip"]


def _cases(n: int) -> list:
    """(label, env name, make kwargs, algo, config kwargs) of each case."""
    ppo = {"epochs": 1, "minibatches": 2}
    ring = {"capacity": 16, "batch_per_env": 2, "updates": 2, "hidden": 32}
    market = {"horizon": 2, "lp_iters": 20, "lp_warm_iters": 10}
    return [
        ("ppo/building", "building", {}, "ppo",
         {"num_envs": 2 * n, "rollout_len": 4, "hidden": 64, **ppo}),
        ("sac/building", "building", {}, "sac",
         {"num_envs": 2 * n, "rollout_len": 4, "capacity": 32,
          "batch_per_env": 2, "updates": 2, "hidden": 64}),
        ("ppo/evcharging-multiagent", "evcharging-multiagent",
         {"periods_delay": 1, "project_action": False}, "ppo",
         {"num_envs": 2 * n, "rollout_len": 2, "hidden": 64, **ppo}),
        ("ppo/evcharging-multiagent (uniform-obs path)",
         "evcharging-multiagent",
         {"periods_delay": 0, "project_action": False}, "ppo",
         {"num_envs": n, "rollout_len": 288, "hidden": 32, "obs_bf16": True,
          **ppo}),
        ("ppo/cogen-multiagent (per-agent stacked)", "cogen-multiagent",
         {"forecast_horizon": 2}, "ppo",
         {"num_envs": 2 * n, "rollout_len": 2, "hidden": 64,
          "reward_scale": 1e-4, **ppo}),
        ("dqn/electricitymarket", "electricitymarket",
         {**market, "discrete": True}, "dqn",
         {"num_envs": 2 * n, "rollout_len": 2, **ring}),
        ("ddpg/electricitymarket", "electricitymarket", market, "ddpg",
         {"num_envs": 2 * n, "rollout_len": 2, **ring}),
    ]


def _rank(n: int, device: str) -> list:
    """Every case on this rank; returns [(label, metrics, mesh shape)]."""
    import torch

    from .bench import make_env
    from .parallel import (DDPGConfig, DQNConfig, PPOConfig, SACConfig,
                           make_ddpg_train_step, make_dqn_train_step,
                           make_mesh, make_sac_train_step, make_train_step)

    factories = {"ppo": (PPOConfig, make_train_step),
                 "sac": (SACConfig, make_sac_train_step),
                 "dqn": (DQNConfig, make_dqn_train_step),
                 "ddpg": (DDPGConfig, make_ddpg_train_step)}
    mesh = make_mesh(n, mp=2 if n % 2 == 0 else 1, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    with tempfile.TemporaryDirectory() as tables:
        for label, name, make_kwargs, algo, cfg_kwargs in _cases(n):
            env, params = make_env(name, dev, tables, **make_kwargs)
            config, factory = factories[algo]
            init_state, train_step = factory(env, params,
                                             config(**cfg_kwargs), mesh=mesh)
            if "uniform-obs" in label and not train_step.uma:
                raise RuntimeError("the uniform-obs path did not engage")
            if "stacked" in label and not train_step.per_agent:
                raise RuntimeError("per-agent stacked policies did not "
                                   "engage")
            gen = torch.Generator(device=dev).manual_seed(0)
            carry = init_state(gen)
            carry, metrics = train_step(carry, gen)
            train_step.check(carry)
            out.append((label, {k: float(v) for k, v in metrics.items()},
                        {"dp": mesh.dp, "mp": mesh.mp}))
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """One step of each case on an ``n_devices``-rank mesh (module
    docstring); prints rank 0's metrics and returns them. Raises if a rank
    fails, a metric is not finite, or two ranks disagree."""
    from .parallel.distributed import spawn

    ranks = spawn(_rank, n_devices, (n_devices, device), device=device)
    for (label, metrics, shape), *others in zip(*ranks):
        if any(o[1] != metrics for o in others):
            raise RuntimeError(f"{label}: the ranks disagree: "
                               f"{[metrics] + [o[1] for o in others]}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"{label}: non-finite metrics {metrics}")
        print(f"dryrun_multichip {label} ok: {metrics} mesh: {shape}",
              flush=True)
    return ranks[0]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("n", type=int, nargs="?", default=2,
                        help="ranks")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; ranks may share the card) or "
                             "cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
