"""Learners: PPO and A2C on the fused, episodic and generic paths, with the
multi-agent paths, and weight conversion from the JAX package's policy
trees."""
from .convert import from_jax, to_jax
from .ppo import (ActorCritic, PPOConfig, StackedActorCritic, init_policy,
                  init_stacked_policy, make_train_step, per_agent_apply,
                  policy_apply, policy_apply_bf16)

__all__ = ["ActorCritic", "StackedActorCritic", "PPOConfig", "init_policy",
           "init_stacked_policy", "make_train_step", "per_agent_apply",
           "policy_apply", "policy_apply_bf16", "from_jax", "to_jax"]
