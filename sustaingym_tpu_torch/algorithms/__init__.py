"""Baseline algorithms over the port's envs: the runner harness
(``base``), the EV baselines (greedy, random, MPC, offline-optimal) and
the building MPC. The imperative runners step the gymnasium adapters of
``compat/``; ``batch_run`` steps the batched envs directly."""
from .base import BaseAlgorithm, RandomAlgorithm, batch_returns, batch_run
from .building import MPCAgent, mpc_action
from .evcharging import (GreedyAlgorithm, MPC, OfflineOptimal,
                         offline_optimal_schedule)
from .evcharging import RandomAlgorithm as EVRandomAlgorithm

__all__ = [
    "BaseAlgorithm", "RandomAlgorithm", "batch_run", "batch_returns",
    "GreedyAlgorithm", "EVRandomAlgorithm", "MPC", "OfflineOptimal",
    "offline_optimal_schedule", "MPCAgent", "mpc_action",
]
