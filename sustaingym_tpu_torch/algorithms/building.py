"""Building MPC controller: the port of ``sustaingym_tpu.algorithms.
building``.

Minimizes beta ||(x_1 - target) o ac|| + (1 - beta) 24 ||u|| over the
predicted RC dynamics with box-bounded actions (the reference's
MPCAgent and its data-driven variant). The reference's ECOS_BB solve is a
fixed-iteration projected gradient descent here, its gradient from
``torch.autograd``.

As in the JAX package, the discrete-time ``BD_d`` is used throughout (the
reference's MPCAgent reads an ``env.B_d`` that BuildingEnv never defines).
"""
from __future__ import annotations

import torch

from ..envs.building.env import (SCALING_FACTOR, BuildingParams,
                                 calc_occupower)
from .base import BaseAlgorithm

__all__ = ["mpc_action", "MPCAgent"]


def mpc_action(params: BuildingParams, x0: torch.Tensor, epoch,
               beta: float | None = None, pnorm: float = 2.0,
               planning_steps: int = 1, iters: int = 300,
               lr: float = 0.05) -> torch.Tensor:
    """Plans ``planning_steps`` ahead from zone temperatures ``x0`` (n,) at
    ``epoch`` and returns the first action (n,)."""
    n = params.n
    dtype = params.A_d.dtype
    if beta is None:
        beta = float(params.error_rate)
    q_rate = (1.0 - beta) * SCALING_FACTOR
    x0 = torch.as_tensor(x0, dtype=dtype, device=params.device)
    epoch = int(epoch)

    avg = torch.sum(x0) / n
    meta = params.metabolism[epoch]
    ghi = params.ghi[epoch]
    if params.data_driven:
        # the identified dynamics' input layout (n + 7 BD_d columns):
        # [avg^2, avg, meta^2, meta, ground, out, u(n), ghi], avg and meta
        # held at their x0 values over the horizon, as the reference's
        # MPCAgent_DataDriven does
        exo = torch.stack([avg * avg, avg, meta * meta, meta,
                           params.ground_temp[epoch], params.out_temp[epoch]])
    else:
        # the physics layout (n + 4 columns): [occupower, ground, out,
        # u(n), ghi]
        exo = torch.stack([calc_occupower(avg, meta),
                           params.ground_temp[epoch], params.out_temp[epoch]])

    def objective(us):
        x, total = x0, 0.0
        for u in us:
            x = params.A_d @ x + params.BD_d @ torch.cat([exo, u, ghi[None]])
            err = (x - params.target) * params.ac_map
            total = total + (
                beta * torch.linalg.vector_norm(err + 1e-12, pnorm)
                + q_rate * torch.linalg.vector_norm(u + 1e-12, pnorm))
        return total

    lo, hi = -params.ac_map, params.ac_map
    us = torch.zeros((planning_steps, n), dtype=dtype, device=params.device)
    for _ in range(iters):
        us.requires_grad_(True)
        (g,) = torch.autograd.grad(objective(us), us)
        with torch.no_grad():
            us = torch.clamp(us - lr * g, lo, hi)
    return us[0].detach()


class MPCAgent(BaseAlgorithm):
    """The imperative wrapper of :func:`mpc_action` over a building gym
    adapter: plans from the adapter's state."""

    def __init__(self, env, beta: float | None = None, pnorm: float = 2.0,
                 planning_steps: int = 1, iters: int = 300):
        super().__init__(env)
        self.params: BuildingParams = env.params
        self._kw = dict(beta=beta, pnorm=pnorm,
                        planning_steps=planning_steps, iters=iters)

    def get_action(self, observation):
        state = self.env._state
        return mpc_action(self.params, state.x[0], state.epoch[0],
                          **self._kw).cpu().numpy()
