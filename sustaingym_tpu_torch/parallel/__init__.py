"""Learners: PPO on the fused episodic path, and weight conversion from
the JAX package's policy trees."""
from .convert import from_jax, to_jax
from .ppo import (ActorCritic, PPOConfig, init_policy, make_train_step,
                  policy_apply, policy_apply_bf16)

__all__ = ["ActorCritic", "PPOConfig", "init_policy", "make_train_step",
           "policy_apply", "policy_apply_bf16", "from_jax", "to_jax"]
