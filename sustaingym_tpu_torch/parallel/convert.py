"""Weight conversion between the JAX package's PPO policy tree and the
port's ``ActorCritic``.

A JAX dense layer is ``{"w": (din, dout), "b": (dout,)}``; ``nn.Linear``
keeps ``weight`` as (dout, din). The flat observation order is the same in
both packages, so ``trunk1`` rows map one to one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import resolve_device
from .ppo import ActorCritic

__all__ = ["from_jax", "to_jax"]

_DENSE = ("trunk1", "trunk2", "mu", "value")


@torch.no_grad()
def from_jax(tree: dict, device="cuda") -> ActorCritic:
    """An ``ActorCritic`` on ``device`` (the card unless the caller asks
    for the CPU) holding the weights of a JAX policy tree of array-likes
    (numpy arrays, or anything ``np.asarray`` reads)."""
    device = resolve_device(device)
    w1 = np.asarray(tree["trunk1"]["w"])
    act_dim = np.asarray(tree["mu"]["w"]).shape[1]
    policy = ActorCritic(w1.shape[0], act_dim, w1.shape[1], device=device)
    for name in _DENSE:
        layer = getattr(policy, name)
        layer.weight.copy_(torch.as_tensor(
            np.asarray(tree[name]["w"], np.float32).T))
        layer.bias.copy_(torch.as_tensor(
            np.asarray(tree[name]["b"], np.float32)))
    policy.log_std.copy_(torch.as_tensor(
        np.asarray(tree["log_std"], np.float32)))
    return policy


@torch.no_grad()
def to_jax(policy: ActorCritic) -> dict:
    """The JAX policy tree (numpy float32 leaves) of ``policy``."""
    def np32(x):
        return x.detach().cpu().float().numpy()

    tree = {name: {"w": np32(getattr(policy, name).weight).T.copy(),
                   "b": np32(getattr(policy, name).bias)}
            for name in _DENSE}
    tree["log_std"] = np32(policy.log_std)
    return tree
