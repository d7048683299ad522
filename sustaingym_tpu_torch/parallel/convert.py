"""Weight conversion between the JAX package's network trees and the
port's modules.

A JAX dense layer is ``{"w": (din, dout), "b": (dout,)}``; ``nn.Linear``
keeps ``weight`` as (dout, din). The flat observation order is the same in
both packages, so ``trunk1`` rows map one to one. The trees:

- the PPO policy (trunk1, trunk2, mu, value, and the vector log_std) maps
  to ``ActorCritic``; a stacked per-agent tree (every leaf with a leading
  (n_agents,) axis, the JAX package's ``per_agent_apply`` policy) to a
  ``StackedActorCritic``, whose weights keep the JAX orientation
  (n_agents, din, dout);
- the SAC actor (trunk1, trunk2, and the dense heads mu and log_std) to a
  ``SACActor``; a critic (l1, l2, out) to a ``Critic``, and the twin
  critics {q1, q2} to an ``nn.ModuleDict`` of two;
- the DQN qnet (trunk1, trunk2, head) to a ``QNet``;
- the DDPG deterministic actor (trunk1, trunk2, mu) to a ``DetActor``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import resolve_device
from .ddpg import DetActor
from .dqn import QNet
from .ppo import ActorCritic, StackedActorCritic, shard_policy
from .sac import Critic, SACActor

__all__ = ["from_jax", "to_jax", "load_jax_carry"]

_DENSE = ("trunk1", "trunk2", "mu", "value")


def _dims(tree: dict, first: str, last: str) -> tuple[int, int, int]:
    """(din, dout, hidden) of a dense tree from its first and last
    layers."""
    w1 = np.asarray(tree[first]["w"])
    return w1.shape[0], np.asarray(tree[last]["w"]).shape[-1], w1.shape[1]


@torch.no_grad()
def _load_dense(module: nn.Module, tree: dict) -> nn.Module:
    """Copies a dense tree's layers into the ``nn.Linear`` children of
    the same names (a ``ModuleDict``'s networks by their keys)."""
    if isinstance(module, nn.ModuleDict):
        for name, net in module.items():
            _load_dense(net, tree[name])
        return module
    for name, layer in module.named_children():
        w = np.asarray(tree[name]["w"], np.float32)
        layer.weight.copy_(torch.tensor(w.T))
        layer.bias.copy_(torch.tensor(
            np.asarray(tree[name]["b"], np.float32)))
    return module


def from_jax(tree: dict, device="cuda", mesh=None) -> nn.Module:
    """The port's module (module docstring) on ``device`` (the card unless
    the caller asks for the CPU) holding the weights of a JAX tree of
    array-likes (numpy arrays, or anything ``np.asarray`` reads). With a
    ``mesh`` whose mp > 1 a PPO policy keeps this rank's shard of the full
    parameters (``ppo.shard_policy``); the other networks are replicated
    and need none."""
    device = resolve_device(device)
    if "value" in tree:
        return shard_policy(_policy_from_jax(tree, device), mesh)
    if "q1" in tree:
        return nn.ModuleDict({q: from_jax(tree[q], device)
                              for q in ("q1", "q2")})
    if "l1" in tree:
        din, dout, hidden = _dims(tree, "l1", "out")
        # l1 takes cat([obs, act]): any split of din serves
        return _load_dense(Critic(din, 0, hidden, device), tree)
    if "head" in tree:
        din, dout, hidden = _dims(tree, "trunk1", "head")
        return _load_dense(QNet(din, 1, dout, hidden, device), tree)
    din, dout, hidden = _dims(tree, "trunk1", "mu")
    if "log_std" in tree:
        return _load_dense(SACActor(din, dout, hidden, device), tree)
    return _load_dense(DetActor(din, dout, hidden, device), tree)


@torch.no_grad()
def _policy_from_jax(tree: dict, device) -> ActorCritic | StackedActorCritic:
    """An ``ActorCritic`` (a ``StackedActorCritic`` for a stacked per-agent
    tree) holding a JAX PPO policy tree."""
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


def _np32(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().float().numpy()


@torch.no_grad()
def to_jax(policy: nn.Module) -> dict:
    """The JAX tree (numpy float32 leaves) of a module of
    :func:`from_jax`."""
    if isinstance(policy, nn.ModuleDict):
        return {name: to_jax(net) for name, net in policy.items()}
    if not isinstance(policy, (ActorCritic, StackedActorCritic)):
        return {name: {"w": _np32(layer.weight).T.copy(),
                       "b": _np32(layer.bias)}
                for name, layer in policy.named_children()}

    def w(layer):
        w = _np32(layer.weight)
        return w if isinstance(policy, StackedActorCritic) else w.T.copy()

    tree = {name: {"w": w(getattr(policy, name)),
                   "b": _np32(getattr(policy, name).bias)}
            for name in _DENSE}
    tree["log_std"] = _np32(policy.log_std)
    return tree


# the networks of an off-policy carry, by their entries in both packages
_NETS = ("actor", "critics", "targets", "actor_target", "qnet", "target")


def load_jax_carry(jax_carry: dict, carry: dict) -> dict:
    """Copies the networks, targets and ``log_alpha`` of a JAX off-policy
    carry (SAC, DQN or DDPG; leaves anything ``np.asarray`` reads) into the
    port's carry of the same learner, in place; returns ``carry``."""
    for name in _NETS:
        if name in carry:
            _load_dense(carry[name], jax_carry[name])
    if "log_alpha" in carry:
        with torch.no_grad():
            carry["log_alpha"].copy_(torch.as_tensor(
                np.asarray(jax_carry["log_alpha"], np.float32)))
    return carry
