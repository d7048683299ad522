"""DDPG learner with the TD3 refinements: ``sustaingym_tpu.parallel.ddpg``
on one card.

A deterministic tanh actor with clipped Gaussian exploration noise
(``expl_noise``), twin critics toward the twin-min target of a smoothed
target action (``policy_noise`` clipped to ``noise_clip``; plain DDPG is
``policy_noise=0`` away), the actor trained through ``q1`` only, and
Polyak targets for the actor and both critics, over the on-device replay
ring (``offpolicy.py``: the rollout and each update as CUDA graphs on the
card). ``mesh`` splits the env batch and the ring over dp, the JAX
package's ``shard_ddpg_carry`` (``offpolicy``).
"""
from __future__ import annotations

import copy
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core import dataclass
from .offpolicy import (Learner, check_gates, dense_init,
                        make_off_policy_step, polyak)
from .ppo import adam
from .sac import box_action, critic_x, init_critic, twin_min

__all__ = ["DDPGConfig", "DetActor", "init_det_actor", "det_actor_apply",
           "make_ddpg_train_step"]


@dataclass
class DDPGConfig:
    num_envs: int = 256
    rollout_len: int = 16
    capacity: int = 1024
    batch_per_env: int = 4
    updates: int = 16
    hidden: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    expl_noise: float = 0.1       # rollout action noise
    policy_noise: float = 0.2     # target smoothing
    noise_clip: float = 0.5
    # replay sampling: False draws shared whole time slices, True per-env
    # slots (parallel/replay.py)
    per_env_sample: bool = False


class DetActor(nn.Module):
    """The JAX deterministic actor tree: trunk1, trunk2, mu."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int,
                 device=None):
        super().__init__()
        self.trunk1 = nn.Linear(obs_dim, hidden, device=device)
        self.trunk2 = nn.Linear(hidden, hidden, device=device)
        self.mu = nn.Linear(hidden, act_dim, device=device)


def init_det_actor(generator: torch.Generator, obs_dim: int, act_dim: int,
                   hidden: int, device=None) -> DetActor:
    """The actor with the JAX package's ``_dense`` initialisation."""
    return dense_init(DetActor(obs_dim, act_dim, hidden, device), generator)


def det_actor_apply(actor: DetActor, obs: torch.Tensor) -> torch.Tensor:
    """obs (..., D) -> actions in (-1, 1)."""
    h = torch.tanh(F.linear(obs, actor.trunk1.weight, actor.trunk1.bias))
    h = torch.tanh(F.linear(h, actor.trunk2.weight, actor.trunk2.bias))
    return torch.tanh(F.linear(h, actor.mu.weight, actor.mu.bias))


def make_ddpg_train_step(env, env_params, cfg: DDPGConfig,
                         capture: bool | None = None, mesh=None
                         ) -> tuple[Callable, Callable]:
    """Builds (init_state, train_step) (``offpolicy.make_off_policy_step``):
    the carry holds ``actor``, ``critics`` ({q1, q2}), their Polyak
    ``actor_target`` and ``targets``, and the Adam optimizers
    ``actor_opt`` and ``critic_opt``; the update metrics are ``q_loss``
    and ``actor_loss``. ``train_step.actor_fn`` is the actor without
    noise."""
    check_gates(env, "heterogeneous per-agent action dims are only "
                "supported by the PPO learner; use --algo ppo")
    act_dim, to_env_action = box_action(
        env, env_params, "DDPG", "discrete envs train with --algo dqn or "
        "the PPO categorical head")
    device = env_params.device

    def init(generator, obs_dim):
        actor = init_det_actor(generator, obs_dim, act_dim, cfg.hidden,
                               device)
        critics = nn.ModuleDict({
            q: init_critic(generator, obs_dim, act_dim, cfg.hidden, device)
            for q in ("q1", "q2")})
        return {"actor": actor, "critics": critics,
                "actor_target": copy.deepcopy(actor).requires_grad_(False),
                "targets": copy.deepcopy(critics).requires_grad_(False),
                "actor_opt": adam(actor.parameters(), cfg.lr, device),
                "critic_opt": adam(critics.parameters(), cfg.lr, device)}

    def act(carry, obs, draws, eps):
        a = det_actor_apply(carry["actor"], obs)
        a = torch.clamp(a + cfg.expl_noise * draws.normal(a.shape,
                                                          obs.device),
                        -1.0, 1.0)
        return a, to_env_action(a)

    def update(carry, batch, draws, red):
        actor, critics = carry["actor"], carry["critics"]
        obs, next_obs = batch["obs"], batch["next_obs"]
        with torch.no_grad():
            # target-policy smoothing (TD3): clipped noise on the target
            # action
            a_next = det_actor_apply(carry["actor_target"], next_obs)
            noise = torch.clamp(
                cfg.policy_noise * draws.normal(a_next.shape, obs.device),
                -cfg.noise_clip, cfg.noise_clip)
            a_next = torch.clamp(a_next + noise, -1.0, 1.0)
            q_n = twin_min(carry["targets"], next_obs, a_next)
            target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * q_n
        x = torch.cat([obs, batch["act"]], -1)
        e1 = critic_x(critics["q1"], x) - target
        e2 = critic_x(critics["q2"], x) - target
        c_loss = 0.5 * (red.mean(e1 ** 2) + red.mean(e2 ** 2))
        carry["critic_opt"].zero_grad(set_to_none=True)
        c_loss.backward()
        red.grads(critics.parameters())
        carry["critic_opt"].step()

        a = det_actor_apply(actor, obs)
        a_loss = -red.mean(critic_x(critics["q1"],
                                    torch.cat([obs, a], -1)))
        carry["actor_opt"].zero_grad(set_to_none=True)
        a_loss.backward(inputs=list(actor.parameters()))
        red.grads(actor.parameters())
        carry["actor_opt"].step()

        polyak(carry["actor_target"], actor, cfg.tau)
        polyak(carry["targets"], critics, cfg.tau)
        return torch.stack([c_loss.detach(), a_loss.detach()])

    def actor(net, obs):
        return to_env_action(det_actor_apply(net, obs))

    learner = Learner(metrics=("q_loss", "actor_loss"),
                      init=init, act=act, update=update,
                      act_field=((act_dim,), torch.float32), actor=actor,
                      actor_key="actor")
    return make_off_policy_step(env, env_params, cfg, learner, capture, mesh)
