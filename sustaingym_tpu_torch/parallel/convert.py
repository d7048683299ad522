"""Weight conversion between the JAX package's PPO policy tree and the
port's ``ActorCritic``.

A JAX dense layer is ``{"w": (din, dout), "b": (dout,)}``; ``nn.Linear``
keeps ``weight`` as (dout, din). The flat observation order is the same in
both packages, so ``trunk1`` rows map one to one. A stacked per-agent tree
(every leaf with a leading (n_agents,) axis, the JAX package's
``per_agent_apply`` policy) maps to a ``StackedActorCritic``, whose weights
keep the JAX orientation (n_agents, din, dout).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import resolve_device
from .ppo import ActorCritic, StackedActorCritic

__all__ = ["from_jax", "to_jax"]

_DENSE = ("trunk1", "trunk2", "mu", "value")


@torch.no_grad()
def from_jax(tree: dict, device="cuda") -> ActorCritic | StackedActorCritic:
    """An ``ActorCritic`` (a ``StackedActorCritic`` for a stacked per-agent
    tree) on ``device`` (the card unless the caller asks for the CPU)
    holding the weights of a JAX policy tree of array-likes (numpy arrays,
    or anything ``np.asarray`` reads)."""
    device = resolve_device(device)
    w1 = np.asarray(tree["trunk1"]["w"])
    act_dim = np.asarray(tree["mu"]["w"]).shape[-1]
    stacked = w1.ndim == 3
    if stacked:
        policy = StackedActorCritic(w1.shape[0], w1.shape[1], act_dim,
                                    w1.shape[2], device=device)
    else:
        policy = ActorCritic(w1.shape[0], act_dim, w1.shape[1],
                             device=device)
    for name in _DENSE:
        layer = getattr(policy, name)
        w = np.asarray(tree[name]["w"], np.float32)
        layer.weight.copy_(torch.as_tensor(w if stacked else w.T))
        layer.bias.copy_(torch.as_tensor(
            np.asarray(tree[name]["b"], np.float32)))
    policy.log_std.copy_(torch.as_tensor(
        np.asarray(tree["log_std"], np.float32)))
    return policy


@torch.no_grad()
def to_jax(policy: ActorCritic | StackedActorCritic) -> dict:
    """The JAX policy tree (numpy float32 leaves) of ``policy``."""
    def np32(x):
        return x.detach().cpu().float().numpy()

    def w(layer):
        w = np32(layer.weight)
        return w if isinstance(policy, StackedActorCritic) else w.T.copy()

    tree = {name: {"w": w(getattr(policy, name)),
                   "b": np32(getattr(policy, name).bias)}
            for name in _DENSE}
    tree["log_std"] = np32(policy.log_std)
    return tree
