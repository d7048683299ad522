"""Double-DQN learner: ``sustaingym_tpu.parallel.dqn`` on one card.

Epsilon-greedy rollouts into the on-device replay ring and Huber-loss
updates toward double-DQN targets (the online argmax scored by a Polyak
target network; the plain max with ``double=False``), each update on
``reward * reward_scale`` (``offpolicy.py``: the rollout and each update as
CUDA graphs on the card).

Action heads, as in the JAX package: ``Discrete(n)`` is one head of n
values (its ``start`` added back in the env action); a ``MultiDiscrete``
with uniform bins gets one independent Q head per action dimension
(branching Q-learning); an agent-axis view (discrete MA-EV) is an extra
batch axis, each agent's heads from ``nvec.shape[-1]``.

The ring keeps ``act`` as int64, the index dtype ``torch.gather`` takes
(the JAX ring keeps int32). ``mesh`` splits the env batch and the ring
over dp, the JAX package's ``shard_dqn_carry`` (``offpolicy``).
"""
from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import Discrete, MultiDiscrete, dataclass
from .offpolicy import (Learner, check_gates, dense_init,
                        make_off_policy_step, polyak)
from .ppo import adam

__all__ = ["DQNConfig", "QNet", "init_qnet", "qnet_apply", "huber_loss",
           "make_dqn_train_step"]


@dataclass
class DQNConfig:
    num_envs: int = 256
    rollout_len: int = 16
    capacity: int = 1024          # ring slots per env
    batch_per_env: int = 4        # sampled steps per env and update
    updates: int = 16             # gradient steps per train step
    hidden: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01             # Polyak target rate
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_iters: int = 50     # train steps
    double: bool = True           # double-DQN targets
    # multiplies rewards inside the TD target (reported metrics unscaled)
    reward_scale: float = 1.0
    # replay sampling: False draws shared whole time slices, True per-env
    # slots (parallel/replay.py)
    per_env_sample: bool = False


class QNet(nn.Module):
    """The JAX qnet tree: trunk1, trunk2, head (act_dim x n_bins)."""

    def __init__(self, obs_dim: int, act_dim: int, n_bins: int, hidden: int,
                 device=None):
        super().__init__()
        self.trunk1 = nn.Linear(obs_dim, hidden, device=device)
        self.trunk2 = nn.Linear(hidden, hidden, device=device)
        self.head = nn.Linear(hidden, act_dim * n_bins, device=device)


def init_qnet(generator: torch.Generator, obs_dim: int, act_dim: int,
              n_bins: int, hidden: int, device=None) -> QNet:
    """The Q network with the JAX package's ``_dense`` initialisation."""
    return dense_init(QNet(obs_dim, act_dim, n_bins, hidden, device),
                      generator)


def qnet_apply(qnet: QNet, obs: torch.Tensor, act_dim: int,
               n_bins: int) -> torch.Tensor:
    """obs (..., D) -> Q-values (..., act_dim, n_bins)."""
    h = torch.tanh(F.linear(obs, qnet.trunk1.weight, qnet.trunk1.bias))
    h = torch.tanh(F.linear(h, qnet.trunk2.weight, qnet.trunk2.bias))
    q = F.linear(h, qnet.head.weight, qnet.head.bias)
    return q.reshape(q.shape[:-1] + (act_dim, n_bins))


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss: 0.5 min(|e|, delta)^2 + delta (|e| - min(|e|,
    delta)), elementwise."""
    abs_e = torch.abs(pred - target)
    quad = torch.clamp(abs_e, max=delta)
    return 0.5 * quad ** 2 + delta * (abs_e - quad)


def _heads(env, space) -> tuple[int, int, int]:
    """(act_dim, n_bins, start) of a Discrete or uniform MultiDiscrete
    space."""
    if isinstance(space, Discrete):
        return 1, int(space.n), int(space.start)
    if isinstance(space, MultiDiscrete):
        nvec = np.asarray(space.nvec)
        if not np.all(nvec == nvec.flat[0]):
            raise ValueError(f"DQN needs uniform bins, got nvec={nvec}")
        ma = bool(getattr(env, "agent_axis", False))
        return (int(nvec.shape[-1]) if ma else int(nvec.size),
                int(nvec.flat[0]), 0)
    raise ValueError(
        f"{env.name}: DQN needs a Discrete/MultiDiscrete action space, got "
        f"{type(space).__name__} — continuous envs train with --algo "
        "ppo/a2c/sac (or discretize, e.g. the market's discrete=True or "
        "MA-EV discrete_bins)")


def make_dqn_train_step(env, env_params, cfg: DQNConfig,
                        capture: bool | None = None, mesh=None
                        ) -> tuple[Callable, Callable]:
    """Builds (init_state, train_step) (``offpolicy.make_off_policy_step``):
    the carry holds ``qnet``, its Polyak ``target``, its Adam ``opt`` and
    ``iter`` (train steps taken, for the linear epsilon decay); the
    metrics are ``mean_reward``, ``epsilon`` (the rollout's) and
    ``q_loss``. ``train_step.actor_fn`` is the greedy action. ``mesh``: the
    dp split (``offpolicy``)."""
    check_gates(env, "heterogeneous per-agent action dims are only "
                "supported by the PPO learner; use --algo ppo")
    space = env.action_space(env_params)
    act_dim, n_bins, start = _heads(env, space)
    discrete = isinstance(space, Discrete)
    device = env_params.device

    def to_env_action(idx):
        # idx (..., act_dim) -> env action (a Discrete scalar + start)
        return idx[..., 0] + start if discrete else idx

    def epsilon(it):
        frac = torch.clamp(it.float() / cfg.eps_decay_iters, 0.0, 1.0)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    def init(generator, obs_dim):
        qnet = init_qnet(generator, obs_dim, act_dim, n_bins, cfg.hidden,
                         device)
        return {"qnet": qnet,
                "target": copy.deepcopy(qnet).requires_grad_(False),
                "opt": adam(qnet.parameters(), cfg.lr, device)}

    def act(carry, obs, draws, eps):
        q = qnet_apply(carry["qnet"], obs, act_dim, n_bins)
        greedy = torch.argmax(q, -1)
        random_a = draws.randint(n_bins, greedy.shape, obs.device)
        explore = draws.mask(greedy.shape, eps, obs.device)
        a = torch.where(explore, random_a, greedy)
        return a, to_env_action(a)

    def update(carry, batch, draws, red):
        qnet = carry["qnet"]
        next_obs = batch["next_obs"]
        with torch.no_grad():
            reward = batch["reward"] * cfg.reward_scale
            q_next_t = qnet_apply(carry["target"], next_obs, act_dim, n_bins)
            if cfg.double:
                # the online net picks the argmax, the target scores it
                sel = torch.argmax(qnet_apply(qnet, next_obs, act_dim,
                                              n_bins), -1)
                q_next = torch.gather(q_next_t, -1, sel[..., None])[..., 0]
            else:
                q_next = torch.amax(q_next_t, -1)
            # branching heads bootstrap independently
            tgt = (reward[..., None]
                   + cfg.gamma * (1.0 - batch["done"][..., None]) * q_next)
        q = qnet_apply(qnet, batch["obs"], act_dim, n_bins)
        q_a = torch.gather(q, -1, batch["act"][..., None])[..., 0]
        loss = red.mean(huber_loss(q_a, tgt))
        carry["opt"].zero_grad(set_to_none=True)
        loss.backward()
        red.grads(qnet.parameters())
        carry["opt"].step()
        polyak(carry["target"], qnet, cfg.tau)
        return loss.detach()[None]

    def actor(net, obs):
        return to_env_action(torch.argmax(
            qnet_apply(net, obs, act_dim, n_bins), -1))

    learner = Learner(metrics=("q_loss",), init=init, act=act,
                      update=update, act_field=((act_dim,), torch.long),
                      actor=actor, actor_key="qnet", epsilon=epsilon)
    return make_off_policy_step(env, env_params, cfg, learner, capture, mesh)
