"""SAC learner: ``sustaingym_tpu.parallel.sac`` on one card.

Twin critics on ``cat([obs, act])`` trained toward the entropy-regularised
twin-min target, a reparameterised tanh-Gaussian actor trained through the
updated critics, a temperature tuned toward ``-act_dim`` (the SAC-v2
heuristic), and Polyak targets, over the on-device replay ring
(``offpolicy.py``: the rollout and each update as CUDA graphs on the
card). Three Adam optimizers with optax's rule (``ppo.adam``), the third
on the 0-d ``log_alpha``; no gradient clipping, as in the JAX package.

Multi-agent views with an agent axis (MA building) train one shared actor
over the (B, n_agents, D) obs, each agent's action width. ``mesh``
splits the env batch and the ring's env axis over dp, the JAX package's
``shard_sac_carry`` (``offpolicy.make_off_policy_step``).
"""
from __future__ import annotations

import copy
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import dataclass
from ..core.graph import device_const
from .offpolicy import (Learner, check_gates, dense_init,
                        make_off_policy_step, polyak)
from .ppo import adam

__all__ = ["SACConfig", "SACActor", "Critic", "init_actor", "init_critic",
           "actor_apply", "critic_apply", "make_sac_train_step",
           "box_action"]

_LOG_STD_LO, _LOG_STD_HI = -5.0, 2.0


@dataclass
class SACConfig:
    num_envs: int = 256
    rollout_len: int = 16
    capacity: int = 1024          # ring slots per env
    batch_per_env: int = 4        # sampled steps per env and update
    updates: int = 16             # gradient steps per train step
    hidden: int = 256
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    init_alpha: float = 0.1
    # target entropy; None is -act_dim (the SAC-v2 heuristic)
    target_entropy: float | None = None
    # replay sampling: False draws shared whole time slices, True per-env
    # slots (parallel/replay.py)
    per_env_sample: bool = False


class SACActor(nn.Module):
    """The JAX actor tree: trunk1, trunk2, and the dense heads mu and
    log_std."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int,
                 device=None):
        super().__init__()
        self.trunk1 = nn.Linear(obs_dim, hidden, device=device)
        self.trunk2 = nn.Linear(hidden, hidden, device=device)
        self.mu = nn.Linear(hidden, act_dim, device=device)
        self.log_std = nn.Linear(hidden, act_dim, device=device)


class Critic(nn.Module):
    """The JAX critic tree: l1 over cat([obs, act]), l2, out."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int,
                 device=None):
        super().__init__()
        self.l1 = nn.Linear(obs_dim + act_dim, hidden, device=device)
        self.l2 = nn.Linear(hidden, hidden, device=device)
        self.out = nn.Linear(hidden, 1, device=device)


def init_actor(generator: torch.Generator, obs_dim: int, act_dim: int,
               hidden: int, device=None) -> SACActor:
    """The actor with the JAX package's ``_dense`` initialisation."""
    return dense_init(SACActor(obs_dim, act_dim, hidden, device), generator)


def init_critic(generator: torch.Generator, obs_dim: int, act_dim: int,
                hidden: int, device=None) -> Critic:
    """A critic with the JAX package's ``_dense`` initialisation."""
    return dense_init(Critic(obs_dim, act_dim, hidden, device), generator)


def actor_apply(actor: SACActor, obs: torch.Tensor):
    """obs (..., D) -> (mu, log_std), log_std smoothly bounded to [-5, 2]
    (a clip would kill the gradients at the rails)."""
    h = torch.tanh(F.linear(obs, actor.trunk1.weight, actor.trunk1.bias))
    h = torch.tanh(F.linear(h, actor.trunk2.weight, actor.trunk2.bias))
    mu = F.linear(h, actor.mu.weight, actor.mu.bias)
    raw = F.linear(h, actor.log_std.weight, actor.log_std.bias)
    log_std = _LOG_STD_LO + 0.5 * (_LOG_STD_HI - _LOG_STD_LO) * (
        torch.tanh(raw) + 1.0)
    return mu, log_std


def critic_x(critic: Critic, x: torch.Tensor) -> torch.Tensor:
    """Q of the concatenated x = cat([obs, act]), (...,)."""
    h = torch.tanh(F.linear(x, critic.l1.weight, critic.l1.bias))
    h = torch.tanh(F.linear(h, critic.l2.weight, critic.l2.bias))
    return F.linear(h, critic.out.weight, critic.out.bias)[..., 0]


def critic_apply(critic: Critic, obs: torch.Tensor,
                 act: torch.Tensor) -> torch.Tensor:
    """Q(obs, act), (...,)."""
    return critic_x(critic, torch.cat([obs, act], -1))


def twin_min(critics: nn.ModuleDict, obs: torch.Tensor,
             act: torch.Tensor) -> torch.Tensor:
    """min(q1, q2) on one concatenation of (obs, act)."""
    x = torch.cat([obs, act], -1)
    return torch.minimum(critic_x(critics["q1"], x),
                         critic_x(critics["q2"], x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sample_tanh_gauss(noise: torch.Tensor, mu: torch.Tensor,
                       log_std: torch.Tensor):
    """Reparameterised tanh-Gaussian sample from N(0, 1) ``noise``:
    (a in (-1, 1), logp), with the stable log(1 - tanh(u)^2) = 2 (log 2 -
    u - softplus(-2u))."""
    std = torch.exp(log_std)
    u = mu + std * noise
    a = torch.tanh(u)
    gauss_logp = torch.sum(
        -0.5 * ((u - mu) ** 2 / (std ** 2) + 2 * log_std
                + math.log(2 * math.pi)), -1)
    corr = torch.sum(2.0 * (math.log(2.0) - u - _softplus(-2.0 * u)), -1)
    return a, gauss_logp - corr


def box_action(env, env_params, algo: str, hint: str):
    """(act_dim, a -> env action) of a Box action space: an action in (-1,
    1) mapped affinely into the box. Refuses another space, naming
    ``hint``."""
    space = env.action_space(env_params)
    if not hasattr(space, "low"):
        raise ValueError(
            f"{env.name}: {algo} needs a continuous (Box) action space, got "
            f"{type(space).__name__} — {hint}")
    ma = bool(getattr(env, "agent_axis", False))
    act_dim = int(space.shape[-1]) if ma else int(np.prod(space.shape))
    device = env_params.device
    low = device_const(space.low, device)
    high = device_const(space.high, device)

    def to_env_action(a):
        return low + (a + 1.0) * 0.5 * (high - low)

    return act_dim, to_env_action


def make_sac_train_step(env, env_params, cfg: SACConfig,
                        capture: bool | None = None, mesh=None
                        ) -> tuple[Callable, Callable]:
    """Builds (init_state, train_step) (``offpolicy.make_off_policy_step``):
    the carry holds ``actor``, ``critics`` ({q1, q2}), ``targets``,
    ``log_alpha`` and their Adam optimizers ``actor_opt``, ``critic_opt``
    and ``alpha_opt``; the update metrics are ``q_loss``, ``actor_loss``,
    ``alpha`` and ``entropy``. ``train_step.actor_fn`` is tanh(mu) mapped
    into the Box. ``mesh``: the dp split (``offpolicy``)."""
    check_gates(env, "heterogeneous per-agent action dims are only "
                "supported by the PPO learner (stacked per-agent "
                "policies); use --algo ppo")
    act_dim, to_env_action = box_action(
        env, env_params, "SAC", "discrete/discretized envs train with the "
        "PPO categorical head (--algo ppo)")
    device = env_params.device
    target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                      else -float(act_dim))

    def init(generator, obs_dim):
        actor = init_actor(generator, obs_dim, act_dim, cfg.hidden, device)
        critics = nn.ModuleDict({
            q: init_critic(generator, obs_dim, act_dim, cfg.hidden, device)
            for q in ("q1", "q2")})
        targets = copy.deepcopy(critics).requires_grad_(False)
        log_alpha = nn.Parameter(torch.tensor(
            math.log(cfg.init_alpha), dtype=torch.float32, device=device))
        return {"actor": actor, "critics": critics, "targets": targets,
                "log_alpha": log_alpha,
                "actor_opt": adam(actor.parameters(), cfg.lr, device),
                "critic_opt": adam(critics.parameters(), cfg.lr, device),
                "alpha_opt": adam([log_alpha], cfg.alpha_lr, device)}

    def act(carry, obs, draws, eps):
        mu, log_std = actor_apply(carry["actor"], obs)
        a, _ = _sample_tanh_gauss(draws.normal(mu.shape, obs.device), mu,
                                  log_std)
        return a, to_env_action(a)

    def update(carry, batch, draws, red):
        actor, critics = carry["actor"], carry["critics"]
        log_alpha = carry["log_alpha"]
        obs, next_obs = batch["obs"], batch["next_obs"]
        alpha = log_alpha.detach().exp()

        # critics toward the twin-min, entropy-regularised target
        with torch.no_grad():
            mu_n, ls_n = actor_apply(actor, next_obs)
            a_n, logp_n = _sample_tanh_gauss(
                draws.normal(mu_n.shape, obs.device), mu_n, ls_n)
            q_n = twin_min(carry["targets"], next_obs, a_n)
            target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * (
                q_n - alpha * logp_n)
        x = torch.cat([obs, batch["act"]], -1)
        e1 = critic_x(critics["q1"], x) - target
        e2 = critic_x(critics["q2"], x) - target
        c_loss = 0.5 * (red.mean(e1 ** 2) + red.mean(e2 ** 2))
        carry["critic_opt"].zero_grad(set_to_none=True)
        c_loss.backward()
        red.grads(critics.parameters())
        carry["critic_opt"].step()

        # the actor through the updated critics, with fresh actions
        mu, ls = actor_apply(actor, obs)
        a, logp = _sample_tanh_gauss(draws.normal(mu.shape, obs.device),
                                     mu, ls)
        a_loss = red.mean(alpha * logp - twin_min(critics, obs, a))
        carry["actor_opt"].zero_grad(set_to_none=True)
        a_loss.backward(inputs=list(actor.parameters()))
        red.grads(actor.parameters())
        carry["actor_opt"].step()

        # the temperature toward the entropy target
        logp = logp.detach()
        al_loss = -red.mean(torch.exp(log_alpha) * (logp + target_entropy))
        carry["alpha_opt"].zero_grad(set_to_none=True)
        al_loss.backward()
        red.grads([log_alpha])
        carry["alpha_opt"].step()

        polyak(carry["targets"], critics, cfg.tau)
        with torch.no_grad():
            return torch.stack([c_loss.detach(), a_loss.detach(),
                                red.param(log_alpha.exp()),
                                -red.mean(logp)])

    def actor(net, obs):
        return to_env_action(torch.tanh(actor_apply(net, obs)[0]))

    learner = Learner(metrics=("q_loss", "actor_loss", "alpha", "entropy"),
                      init=init, act=act, update=update,
                      act_field=((act_dim,), torch.float32), actor=actor,
                      actor_key="actor")
    return make_off_policy_step(env, env_params, cfg, learner, capture, mesh)
