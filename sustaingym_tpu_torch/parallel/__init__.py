"""Learners: PPO and A2C on the fused, episodic and generic paths, with the
multi-agent paths; SAC, double-DQN and TD3-style DDPG over the on-device
replay ring; the training loop; weight conversion from the JAX package's
trees; and the (dp, mp) rank mesh on ``torch.distributed``."""
from .convert import from_jax, load_jax_carry, to_jax
from .ddpg import DDPGConfig, make_ddpg_train_step
from .distributed import (init_distributed, is_distributed,
                          process_local_batch, process_rows, spawn)
from .mesh import Mesh, make_mesh
from .dqn import DQNConfig, make_dqn_train_step
from .ppo import (ActorCritic, PPOConfig, StackedActorCritic, init_policy,
                  init_stacked_policy, make_train_step, per_agent_apply,
                  policy_apply, policy_apply_bf16)
from .runner import run_train_loop, train, train_ddpg, train_dqn, train_sac
from .sac import SACConfig, make_sac_train_step

__all__ = ["ActorCritic", "StackedActorCritic", "PPOConfig", "init_policy",
           "init_stacked_policy", "make_train_step", "per_agent_apply",
           "policy_apply", "policy_apply_bf16", "from_jax", "to_jax",
           "load_jax_carry", "SACConfig", "make_sac_train_step",
           "DQNConfig", "make_dqn_train_step", "DDPGConfig",
           "make_ddpg_train_step", "run_train_loop", "train", "train_sac",
           "train_dqn", "train_ddpg", "Mesh", "make_mesh",
           "init_distributed", "is_distributed", "process_local_batch",
           "process_rows", "spawn"]
