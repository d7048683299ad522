"""Core runtime: dataclass helpers, spaces, the env protocol and rollouts."""
from .env import (FunctionalEnv, TimeStep, autoreset_step,
                  capturable_autoreset_step, kernel_seed, resolve_device)
from .rollout import (batch_reset, batch_rollout, episode_return,
                      random_policy, rollout)
from .spaces import (Box, DictSpace, Discrete, MultiDiscrete, Space, flatdim,
                     flatten)
from .struct import dataclass, replace, tree_map, tree_select, tree_stack

__all__ = ["FunctionalEnv", "TimeStep", "autoreset_step",
           "capturable_autoreset_step", "kernel_seed", "resolve_device",
           "batch_reset", "batch_rollout", "rollout", "episode_return",
           "random_policy", "Box", "Discrete",
           "MultiDiscrete", "DictSpace", "Space", "flatdim", "flatten",
           "dataclass", "replace", "tree_map", "tree_select", "tree_stack"]
