"""Benchmark lines of the PyTorch port: env-steps/s of each trainer (PPO,
A2C and the off-policy SAC, DQN and DDPG) and each simulation tier on one
card (agent-steps/s for a multi-agent view's trainer).

    python3 sustaingym_tpu_torch/bench.py --env all
    python3 sustaingym_tpu_torch/bench.py --env market
    python3 sustaingym_tpu_torch/bench.py --env evcharging-multiagent

Prints one JSON line per configuration, in the shape of the JAX package's
``bench.py`` lines: ``metric``, ``value``, ``unit``, ``batch``,
``rollout_len``, the configuration's flags, ``device`` (the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them) and ``vs_baseline`` (null: the JAX
bench's reference baselines were measured on another host). No floors:
``bench_expected.json`` holds the TPU's, which never apply here.

Each value is the best of ``REPEATS`` synchronised calls after one
warm-up call; the warm-up holds each trainer's CUDA-graph captures
(``parallel/ppo.py``) and the market tier's (``core/graph.py``).

Configurations (``PERF.md`` section 4; ``TRAINERS``, ``OFF_POLICY`` and
``SIM_TIERS``, which ``chip_smoke.py`` runs too):

- trainers: EV 8192 x 288 (bf16 obs, 96 minibatches, projection on: the
  policy-in-kernel path), EV episodic (the same with float32 obs: the
  lockstep ``batch_unroll``), EV generic (8192 envs, rollout_len 64, 16
  minibatches, float32 obs: the JAX CLI's default rollout); building
  fused (bf16 obs) and episodic (float32 obs), 8192 x 288, 96
  minibatches, on the tables of
  ``envs/building/synthetic.py``; cogen 8192 x 96, 24 minibatches;
  datacenter 4096 x 672, 84 minibatches; market 4096 x 288, 36
  minibatches, with Box bids and with ``discrete=True``; the multi-agent
  views of the JAX bench (``bench.py:525-556``), in agent-steps/s with
  ``n_agents``: MA-EV (caltech, 54 station agents) 512 x 288, 36
  minibatches, bf16 obs, projection off, ``periods_delay`` 0 (the
  uniform-obs path) and 2 (the agent-axis episodic path); MA cogen 4096 x
  96, 24 minibatches, per-agent stacked policies (reward_scale 1e-4, as
  the cogen line and the CLI);
- off-policy trainers (``OFF_POLICY``, the JAX bench's six lines,
  ``bench.py:513, 553-570``; H = 256, 16 updates of ``batch_per_env`` 4 a
  train step, capacity 1024 unless listed): SAC on the synthetic building
  4096 x 64; DQN on the discrete market and DDPG and SAC on the market,
  4096 x 32; SAC on EV with the projection off, 2048 x 64; DQN on
  discrete MA-EV (``discrete_bins`` 5, projection off), 128 x 32,
  capacity 64, in agent-steps/s. Each train step is the rollout and the
  update as CUDA graphs (``parallel/offpolicy.py``);
- simulation tiers: EV 32768 x 288, cogen 262144 x 96, datacenter
  262144 x 672, building 524288 x 288 (each env's ``fused_rollout``, the
  episode kernels with in-kernel random actions), market 4096 x 288
  (``batch_rollout`` with random bids through the captured episode loop).

``--env off-policy`` prints the six off-policy lines alone.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

# PERF.md section 4's configurations, run by this bench and by
# chip_smoke.py. Trainers: label -> (metric, env, make kwargs, PPOConfig
# kwargs besides ``HIDDEN`` and ``EPOCHS``).
HIDDEN, EPOCHS = 256, 4
TRAINERS = {
    "EV": ("ppo_evcharging_train_env_steps_per_s_per_chip", "evcharging",
           {}, dict(num_envs=8192, minibatches=96, obs_bf16=True)),
    "EV episodic": ("ppo_evcharging_episodic_train_env_steps_per_s_per_chip",
                    "evcharging", {}, dict(num_envs=8192, minibatches=96)),
    "EV generic": ("ppo_evcharging_generic_train_env_steps_per_s_per_chip",
                   "evcharging", {},
                   dict(num_envs=8192, rollout_len=64, minibatches=16)),
    "building fused": ("ppo_building_train_env_steps_per_s_per_chip",
                       "building", {},
                       dict(num_envs=8192, minibatches=96, obs_bf16=True)),
    "building episodic": (
        "ppo_building_episodic_train_env_steps_per_s_per_chip", "building",
        {}, dict(num_envs=8192, minibatches=96)),
    "cogen": ("ppo_cogen_train_env_steps_per_s_per_chip", "cogen", {},
              dict(num_envs=8192, minibatches=24, reward_scale=1e-4)),
    "datacenter": ("ppo_datacenter_train_env_steps_per_s_per_chip",
                   "datacenter", {}, dict(num_envs=4096, minibatches=84)),
    "market": ("ppo_electricitymarket_train_env_steps_per_s_per_chip",
               "electricitymarket", {}, dict(num_envs=4096, minibatches=36)),
    "market discrete": (
        "ppo_electricitymarket_discrete_train_env_steps_per_s_per_chip",
        "electricitymarket", {"discrete": True},
        dict(num_envs=4096, minibatches=36)),
    "MA EV": ("ppo_ma_evcharging_train_agent_steps_per_s_per_chip",
              "evcharging-multiagent",
              {"project_action": False, "periods_delay": 0},
              dict(num_envs=512, minibatches=36, obs_bf16=True)),
    "MA EV delay2": (
        "ppo_ma_evcharging_delay2_train_agent_steps_per_s_per_chip",
        "evcharging-multiagent",
        {"project_action": False, "periods_delay": 2},
        dict(num_envs=512, minibatches=36, obs_bf16=True)),
    "MA cogen": ("ppo_ma_cogen_train_agent_steps_per_s_per_chip",
                 "cogen-multiagent", {},
                 dict(num_envs=4096, minibatches=24, reward_scale=1e-4)),
}
# the off-policy trainers: label -> (metric, algo, env, make kwargs,
# config kwargs besides ``HIDDEN``)
OFF_POLICY = {
    "SAC building": ("sac_building_train_env_steps_per_s_per_chip", "sac",
                     "building", {},
                     dict(num_envs=4096, rollout_len=64, capacity=1024,
                          updates=16, batch_per_env=4)),
    "DQN market": ("dqn_electricitymarket_train_env_steps_per_s_per_chip",
                   "dqn", "electricitymarket", {"discrete": True},
                   dict(num_envs=4096, rollout_len=32)),
    "DDPG market": ("ddpg_electricitymarket_train_env_steps_per_s_per_chip",
                    "ddpg", "electricitymarket", {},
                    dict(num_envs=4096, rollout_len=32)),
    "SAC EV": ("sac_evcharging_train_env_steps_per_s_per_chip", "sac",
               "evcharging", {"project_action": False},
               dict(num_envs=2048, rollout_len=64)),
    "SAC market": ("sac_electricitymarket_train_env_steps_per_s_per_chip",
                   "sac", "electricitymarket", {},
                   dict(num_envs=4096, rollout_len=32)),
    "DQN MA EV": ("dqn_ma_evcharging_train_agent_steps_per_s_per_chip",
                  "dqn", "evcharging-multiagent",
                  {"discrete_bins": 5, "project_action": False},
                  dict(num_envs=128, rollout_len=32, capacity=64)),
}
# simulation tiers: env -> batch
SIM_TIERS = {"evcharging": 32768, "cogen": 262144, "datacenter": 262144,
             "building": 524288, "electricitymarket": 4096}
ENVS = tuple(SIM_TIERS)
MA_ENVS = ("evcharging-multiagent", "cogen-multiagent")
REPEATS = 3


def train_config(label: str, **overrides):
    """The ``PPOConfig`` of trainer ``label`` of ``TRAINERS``, with
    ``overrides``."""
    from sustaingym_tpu_torch.parallel import PPOConfig
    kwargs = dict(hidden=HIDDEN, epochs=EPOCHS, **TRAINERS[label][3])
    kwargs.update(overrides)
    return PPOConfig(**kwargs)


def off_policy_trainer(label: str, env, params, capture: bool = True,
                       **overrides):
    """(cfg, init_state, train_step) of off-policy trainer ``label`` of
    ``OFF_POLICY``, its config with ``overrides``."""
    from sustaingym_tpu_torch import parallel as P
    factories = {"sac": (P.SACConfig, P.make_sac_train_step),
                 "dqn": (P.DQNConfig, P.make_dqn_train_step),
                 "ddpg": (P.DDPGConfig, P.make_ddpg_train_step)}
    config, factory = factories[OFF_POLICY[label][1]]
    cfg = config(**dict(dict(hidden=HIDDEN, **OFF_POLICY[label][4]),
                        **overrides))
    return (cfg,) + factory(env, params, cfg, capture=capture)


def card() -> str:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    import torch
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return line[torch.cuda.current_device()]


def best_of(fn) -> float:
    """Best wall seconds of ``REPEATS`` synchronised calls of ``fn`` after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def free():
    """Releases what the last line's trainer or rollout held."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def make_env(name: str, device, tables: str | None, **kwargs):
    """``make(name)``, the building (and its multi-agent view) on the
    tables written into ``tables``."""
    from sustaingym_tpu_torch import make
    if name not in ("building", "building-multiagent"):
        return make(name, device=device, **kwargs)
    from sustaingym_tpu_torch.envs import building
    from sustaingym_tpu_torch.envs.building.synthetic import (
        write_building_tables)
    htm, epw = write_building_tables(tables)
    return make(name, building=htm, weather=epw, location="Tucson",
                device=device, root=tables,
                u_wall=building.BUILDINGS["OfficeSmall"][1], **kwargs)


def bench_train(label: str, device, tables) -> dict:
    """Env-steps/s (agent-steps/s for a multi-agent view, with
    ``n_agents``) of one PPO train step (rollout, re-scoring + GAE,
    minibatch epochs) of trainer ``label`` as CUDA graphs; the generic
    rollout's envs carry over from one timed step to the next."""
    import torch
    from sustaingym_tpu_torch.parallel import make_train_step
    metric, name, make_kwargs, _ = TRAINERS[label]
    env, params = make_env(name, device, tables, **make_kwargs)
    cfg = train_config(label)
    init_state, train_step = make_train_step(env, params, cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    carry = init_state(gen)
    steps, agents = train_step.rollout_len, train_step.n_agents
    best = best_of(lambda: train_step(carry, gen))
    result = {"metric": metric,
              "value": round(cfg.num_envs * steps * agents / best, 1),
              "unit": "agent-steps/s" if agents > 1 else "env-steps/s",
              "batch": cfg.num_envs, "rollout_len": steps, "device": card(),
              "vs_baseline": None,
              "episodic_rollout": train_step.path != "generic",
              "minibatches": cfg.minibatches,
              "cuda_graphs": train_step.graphs is not None}
    if agents > 1:
        result["n_agents"] = agents
    if train_step.uma:
        result["uniform_obs"] = True
    if train_step.per_agent:
        result["per_agent_policy"] = True
    for key in ("periods_delay", "project_action"):
        if key in make_kwargs:
            result[key] = make_kwargs[key]
    if train_step.path == "fused":
        result["fused_policy_rollout"] = True
    if cfg.obs_bf16:
        result["obs_bf16"] = True
    if make_kwargs.get("discrete"):
        result["discrete"] = True
    return result


def bench_off_policy(label: str, device, tables) -> dict:
    """Env-steps/s (agent-steps/s for discrete MA-EV, with ``n_agents``)
    of one off-policy train step of trainer ``label`` (the rollout into
    the ring and the updates, as CUDA graphs); the envs and the ring carry
    over from one timed step to the next."""
    import torch
    metric, algo, name, make_kwargs, _ = OFF_POLICY[label]
    env, params = make_env(name, device, tables, **make_kwargs)
    cfg, init_state, train_step = off_policy_trainer(label, env, params)
    gen = torch.Generator(device=device).manual_seed(0)
    carry = init_state(gen)
    agents = train_step.n_agents
    best = best_of(lambda: train_step(carry, gen))
    result = {"metric": metric,
              "value": round(cfg.num_envs * cfg.rollout_len * agents / best,
                             1),
              "unit": "agent-steps/s" if agents > 1 else "env-steps/s",
              "batch": cfg.num_envs, "rollout_len": cfg.rollout_len,
              "device": card(), "vs_baseline": None, "algo": algo,
              "capacity": cfg.capacity, "updates": cfg.updates,
              "batch_per_env": cfg.batch_per_env,
              "cuda_graphs": train_step.graphs is not None}
    if agents > 1:
        result["n_agents"] = agents
    result.update({k: v for k, v in make_kwargs.items()})
    return result


def bench_sim(name: str, batch: int, device, tables) -> dict:
    """Env-steps/s of the simulation tier: the env's ``fused_rollout``
    (episode kernels, in-kernel random actions), or for the market
    ``batch_rollout`` with random bids through the captured episode
    loop."""
    import torch
    from sustaingym_tpu_torch.core import batch_rollout, random_policy
    from sustaingym_tpu_torch.core.graph import Graphs
    env, params = make_env(name, device, tables)
    steps = env.episode_steps(params)
    gen = torch.Generator(device=device).manual_seed(0)
    if name == "electricitymarket":
        policy, graphs = random_policy(env, params, batch), Graphs(device)
        mode = "captured_episode_loop"

        def run():
            batch_rollout(env, params, policy, None, gen, batch, steps,
                          graphs=graphs)
    else:
        mode = "fused_kernel_rollout"

        def run():
            env.fused_rollout(params, batch, steps, generator=gen)
    best = best_of(run)
    result = {"metric": f"{name}_env_steps_per_s_per_chip",
              "value": round(batch * steps / best, 1),
              "unit": "env-steps/s", "batch": batch, "rollout_len": steps,
              "device": card(), "vs_baseline": None, "mode": mode}
    if name == "evcharging":
        result["project_action"] = True
    return result


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="all",
                        choices=("all", "market", "off-policy") + ENVS
                        + MA_ENVS,
                        help="one env's lines (trainers and simulation "
                             "tier; 'market' = electricitymarket), the "
                             "off-policy trainers' lines, or all")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    device = torch.device("cuda")
    # the plain full-f32 matmuls the port's numerics assume
    torch.backends.cuda.matmul.allow_tf32 = False
    name = "electricitymarket" if args.env == "market" else args.env
    tables = tempfile.mkdtemp(prefix="bench_building_tables_")
    try:
        for label, (_, env, _, _) in TRAINERS.items():
            if name in ("all", env):
                print(json.dumps(bench_train(label, device, tables)),
                      flush=True)
                free()
        for label, (_, _, env, _, _) in OFF_POLICY.items():
            if name in ("all", "off-policy", env):
                print(json.dumps(bench_off_policy(label, device, tables)),
                      flush=True)
                free()
        for env, batch in SIM_TIERS.items():
            if name in ("all", env):
                print(json.dumps(bench_sim(env, batch, device, tables)),
                      flush=True)
                free()
    finally:
        shutil.rmtree(tables)


if __name__ == "__main__":
    main()
