"""Core runtime: dataclass helpers, spaces, the env protocol and rollouts."""
from .env import (FunctionalEnv, ScheduleGuard, TimeStep, autoreset_step,
                  capturable_autoreset_step, draw_env_rows, env_offset,
                  env_shard, kernel_seed, phased_autoreset_step,
                  reset_schedule, resolve_device)
from .rollout import (batch_reset, batch_rollout, episode_return,
                      random_policy, rollout)
from .spaces import (Box, DictSpace, Discrete, MultiDiscrete, Space, flatdim,
                     flatten)
from .struct import (dataclass, replace, tree_assign_, tree_map,
                     tree_select, tree_stack)

__all__ = ["FunctionalEnv", "TimeStep", "autoreset_step",
           "capturable_autoreset_step", "phased_autoreset_step",
           "reset_schedule", "ScheduleGuard", "env_shard", "draw_env_rows",
           "env_offset", "kernel_seed", "resolve_device",
           "batch_reset", "batch_rollout", "rollout", "episode_return",
           "random_policy", "Box", "Discrete",
           "MultiDiscrete", "DictSpace", "Space", "flatdim", "flatten",
           "dataclass", "replace", "tree_assign_", "tree_map", "tree_select",
           "tree_stack"]
