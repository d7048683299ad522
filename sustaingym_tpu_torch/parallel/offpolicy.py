"""The train step shared by the off-policy learners (``sac.py``, ``dqn.py``,
``ddpg.py``): the rollout into the replay ring and the loop of gradient
updates, eager or as CUDA graphs.

One train step, as the JAX package's one jitted program:

1. **rollout**: ``rollout_len`` steps of the env's batched ``step`` with
   autoreset (:func:`core.env.capturable_autoreset_step`), the actions
   drawn by the learner from the carried obs, the env states and flat obs
   carried from one train step to the next. The transitions go into the
   ring as one block (``replay.write_block``) when ``capacity %
   rollout_len == 0``, else one slot a step (``replay.write_transition``);
   ``done`` is broadcast over an agent axis before it is stored;
2. **updates**: ``updates`` times, ring slots drawn below ``min(written,
   capacity)`` (``replay.sample_transitions``) and one gradient update of
   the learner on them, its metrics summed on the device.

On a CUDA device (``capture=True``, the default) the rollout is one CUDA
graph (``core/graph.py``), replayed once a train step, and one update is
another, replayed ``updates`` times, each replay drawing its own slots
and noise from the registered generator. Both are captured at the first
train step. The rollout's graph restores ``written`` (and DQN's ``iter``)
after its warm-up but not the ring: the warm-up writes the very slots
that the replay after it writes again, from the same inputs and generator
state, so no clone of the ring is made. The update's graph restores every
network, target and optimizer state. ``capture=False`` runs the same
kernels eagerly.

The test hook: ``train_step(carry, generator, draws=...)`` takes the
draws prescribed (a list of tensors for each rollout step and for each
update, in the order the learner draws them) instead of drawing them from
the generator; it runs eagerly. Nothing on the main path passes it.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..core import capturable_autoreset_step, flatten
from ..core.graph import Graphs, tree_leaves
from .ppo import _adam_state
from .replay import (init_ring, ring_slots, sample_transitions, write_block,
                     write_transition)

__all__ = ["Draws", "Learner", "make_off_policy_step", "check_gates",
           "polyak", "dense_init"]


class Draws:
    """The random draws of one rollout step or one update: from
    ``generator``, or, when ``prescribed`` (a list of tensors) is given,
    its tensors in order, each checked against the shape asked for."""

    def __init__(self, generator: torch.Generator,
                 prescribed: list | None = None):
        self.generator = generator
        self.prescribed = None if prescribed is None else list(prescribed)

    def _next(self, shape, device, dtype) -> torch.Tensor:
        if not self.prescribed:
            raise ValueError(f"no prescribed draw left for shape {shape}")
        x = torch.as_tensor(np.array(self.prescribed.pop(0)))
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"prescribed draw of shape {tuple(x.shape)}, "
                             f"the learner draws {tuple(shape)}")
        return x.to(device=device, dtype=dtype)

    def normal(self, shape, device) -> torch.Tensor:
        """N(0, 1) float32."""
        if self.prescribed is not None:
            return self._next(shape, device, torch.float32)
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device)

    def randint(self, high: int, shape, device) -> torch.Tensor:
        """Integers in [0, high), int64."""
        if self.prescribed is not None:
            return self._next(shape, device, torch.long)
        g = self.generator
        return torch.randint(high, shape, generator=g, device=g.device)

    def mask(self, shape, p: torch.Tensor, device) -> torch.Tensor:
        """True with probability ``p`` (``u < p``, u ~ U[0, 1) float32)."""
        if self.prescribed is not None:
            return self._next(shape, device, torch.bool)
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device) < p

    def slots(self, shape, written: torch.Tensor, capacity: int
              ) -> torch.Tensor:
        """Ring slots below ``min(written, capacity)``
        (``replay.ring_slots``)."""
        if self.prescribed is not None:
            return self._next(shape, written.device, torch.long)
        g = self.generator
        return ring_slots(torch.rand(shape, generator=g, device=g.device),
                          written, capacity)


@dataclasses.dataclass
class Learner:
    """What a learner adds to the shared train step."""
    metrics: tuple[str, ...]   # the update's metrics, in their order
    # (generator, obs_dim) -> the carry's networks, targets, optimizers
    init: Callable[[torch.Generator, int], dict]
    # (carry, flat obs, draws, epsilon) -> (ring action, env action)
    act: Callable[..., tuple[torch.Tensor, Any]]
    # (carry, batch, draws) -> the metrics of one update, (len(metrics),)
    update: Callable[[dict, dict, Draws], torch.Tensor]
    act_field: tuple[tuple, torch.dtype]   # the ring's act, per env
    # (networks, flat obs) -> deterministic env actions
    actor: Callable[[Any, torch.Tensor], Any]
    actor_key: str
    epsilon: Callable | None = None   # DQN: iter -> exploration epsilon


def check_gates(env, per_agent_msg: str):
    """The JAX learners' common refusals: an env the learners cannot
    train (``ppo_incompatible``) and per-agent stacked policies."""
    if getattr(env, "ppo_incompatible", None):
        raise ValueError(env.ppo_incompatible)
    if getattr(env, "per_agent_policy", False):
        raise ValueError(f"{env.name}: {per_agent_msg}")


@torch.no_grad()
def dense_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX learners' ``_dense``: each ``nn.Linear`` child's weight
    N(0, 1) * sqrt(2 / din), drawn (din, dout) as the JAX tree holds it,
    and a zero bias."""
    for layer in module.children():
        dout, din = layer.weight.shape
        w = torch.randn((din, dout), generator=generator,
                        device=generator.device)
        layer.weight.copy_((w * (2.0 / din) ** 0.5).t())
        layer.bias.zero_()
    return module


@torch.no_grad()
def polyak(target: nn.Module, online: nn.Module, tau: float):
    """target <- (1 - tau) * target + tau * online, in place."""
    tp, op = list(target.parameters()), list(online.parameters())
    torch._foreach_mul_(tp, 1.0 - tau)
    torch._foreach_add_(tp, op, alpha=tau)


def _weights(carry: dict) -> list[torch.Tensor]:
    """Every network's and target's parameters, and loose parameters
    (``log_alpha``)."""
    out = []
    for v in carry.values():
        if isinstance(v, nn.Module):
            out += list(v.parameters())
        elif isinstance(v, nn.Parameter):
            out.append(v)
    return out


def _update_state(carry: dict) -> list[torch.Tensor]:
    """The tensors an update writes: :func:`_weights` and every
    optimizer's state."""
    return _weights(carry) + [x for v in carry.values()
                              if isinstance(v, torch.optim.Optimizer)
                              for x in _adam_state(v)]


def make_off_policy_step(env, env_params, cfg, learner: Learner,
                         capture: bool = True):
    """Builds (init_state, train_step) of an off-policy learner (module
    docstring).

    ``init_state(generator) -> carry``: the learner's networks, targets and
    optimizers, the zeroed ring (``buffer``: obs, act, reward, next_obs,
    done), ``written`` (0-d int64), DQN's ``iter``, and the envs' states
    and flat obs reset from ``generator``. ``train_step(carry, generator,
    *, draws=None) -> (carry, metrics)`` advances the carry in place and
    returns 0-d metric tensors: ``mean_reward`` (over the rollout's steps,
    envs and agents), DQN's ``epsilon``, and the mean of each update
    metric over the updates. Its phases are attributes, for timing them
    apart: ``rollout(carry, generator)`` and ``update(carry, generator)``
    (the summed update metrics); and ``graphs`` (None without capture),
    ``rollout_len``, ``n_agents``, ``actor_fn(networks,
    obs_raw)`` (the deterministic evaluation actions of raw batched obs)
    and ``actor_key`` (the carry's entry it takes)."""
    ma = bool(getattr(env, "agent_axis", False))
    device = env_params.device
    obs_space = env.observation_space(env_params)
    T, cap = int(cfg.rollout_len), int(cfg.capacity)
    block = cap % T == 0
    step = capturable_autoreset_step(env)
    graphs = Graphs(device) if capture and device.type == "cuda" else None
    n_agents = int(env.action_space(env_params).shape[0]) if ma else 1

    def prep(obs_raw) -> torch.Tensor:
        """The flat float32 obs: a view's (B, n_agents, D) as they are, a
        single-agent env's flattened."""
        if ma:
            return obs_raw.float()
        return flatten(obs_space, obs_raw, batch_dims=1)

    def init_state(generator: torch.Generator) -> dict:
        if graphs is not None:
            graphs.clear()           # the last carry's captures and pool
        states, ts = env.reset(env_params, generator, cfg.num_envs)
        obs = prep(ts.obs)
        carry = learner.init(generator, obs.shape[-1])
        lead = tuple(obs.shape[:-1])   # (num_envs,) or (num_envs, n_agents)
        act_shape, act_dtype = learner.act_field
        f32 = torch.float32
        carry["buffer"] = init_ring(cap, {
            "obs": (lead + obs.shape[-1:], f32),
            "act": (lead + tuple(act_shape), act_dtype),
            "reward": (lead, f32),
            "next_obs": (lead + obs.shape[-1:], f32),
            "done": (lead, f32)}, device)
        carry["written"] = torch.zeros((), dtype=torch.long, device=device)
        if learner.epsilon is not None:
            carry["iter"] = torch.zeros((), dtype=torch.long, device=device)
        carry["env_states"], carry["obs"] = states, obs
        return carry

    def ring_ids(carry: dict) -> tuple:
        return tuple(id(x) for x in tree_leaves(carry["buffer"])) + (
            id(carry["written"]),)

    @torch.no_grad()
    def rollout_body(carry, generator, prescribed, states, obs):
        """T autoreset steps from (states, obs), their transitions written
        into the ring: the part of the rollout that a CUDA graph
        captures."""
        ring, written = carry["buffer"], carry["written"]
        eps = None
        if learner.epsilon is not None:
            eps = learner.epsilon(carry["iter"])
            carry["iter"].add_(1)
        rows, means = [], []
        for t in range(T):
            draws = Draws(generator,
                          None if prescribed is None else prescribed[t])
            ring_act, action = learner.act(carry, obs, draws, eps)
            states, ts = step(env_params, states, action, generator)
            next_obs = prep(ts.obs)
            reward, done = ts.reward, ts.done
            if done.ndim < reward.ndim:   # agent-axis rewards
                done = done.reshape(done.shape + (1,) * (
                    reward.ndim - done.ndim)).expand(reward.shape)
            tr = {"obs": obs, "act": ring_act, "reward": reward,
                  "next_obs": next_obs, "done": done.float()}
            if block:
                rows.append(tr)
            else:
                write_transition(ring, tr, written, cap)
                written.add_(1)
            means.append(reward.mean())
            obs = next_obs
        if block:
            write_block(ring, {k: torch.stack([r[k] for r in rows])
                               for k in ring}, written, cap)
            written.add_(T)
        out = (states, obs, torch.stack(means).mean())
        return out if eps is None else out + (eps,)

    def rollout(carry: dict, generator: torch.Generator,
                draws: list | None = None) -> tuple:
        """The rollout phase: advances the carry's envs and ring; returns
        (mean_reward,) or, for DQN, (mean_reward, epsilon)."""
        fn = partial(rollout_body, carry, generator, draws)
        inputs = (carry["env_states"], carry["obs"])
        if graphs is None or draws is not None:
            out = fn(*inputs)
        else:
            state = [carry["written"]] + (
                [carry["iter"]] if "iter" in carry else [])
            key = (("rollout", id(generator)) + ring_ids(carry)
                   + tuple(map(id, state + _weights(carry)))
                   + tuple((x.shape, x.dtype) for x in tree_leaves(inputs)))
            out = graphs(key, fn, *inputs, generators=(generator,),
                         state=state, slot="rollout")
        carry["env_states"], carry["obs"] = out[0], out[1]
        return out[2:]

    def update_body(carry, generator, prescribed, sums):
        """One gradient update on ring slots drawn below ``written``, its
        metrics added to ``sums``."""
        draws = Draws(generator, prescribed)
        envs = carry["buffer"]["reward"].shape[1]
        shape = ((cfg.batch_per_env, envs) if cfg.per_env_sample
                 else (cfg.batch_per_env,))
        idx = draws.slots(shape, carry["written"], cap)
        batch = sample_transitions(carry["buffer"], carry["written"], cap,
                                   cfg.batch_per_env,
                                   per_env_sample=cfg.per_env_sample, idx=idx)
        metrics = learner.update(carry, batch, draws)
        with torch.no_grad():
            sums.add_(metrics)
        return sums

    def update(carry: dict, generator: torch.Generator,
               draws: list | None = None) -> torch.Tensor:
        """The update phase: ``updates`` gradient updates; returns the
        sums of their metrics, (len(metrics),)."""
        sums = torch.zeros(len(learner.metrics), device=device)
        if graphs is None or draws is not None:
            for u in range(cfg.updates):
                update_body(carry, generator,
                            None if draws is None else draws[u], sums)
            return sums
        state = _update_state(carry)
        key = (("update", id(generator)) + ring_ids(carry)
               + tuple(map(id, state)))
        return graphs(key, partial(update_body, carry, generator, None),
                      sums, generators=(generator,), state=state,
                      repeat=cfg.updates, slot="update")

    def train_step(carry: dict, generator: torch.Generator, *,
                   draws: dict | None = None):
        roll = rollout(carry, generator,
                       None if draws is None else draws["rollout"])
        # copied out before the update's graph runs: the next rollout
        # replay rewrites the graph's outputs
        metrics = {"mean_reward": roll[0].clone()}
        if learner.epsilon is not None:
            metrics["epsilon"] = roll[1].clone()
        sums = update(carry, generator,
                      None if draws is None else draws["updates"])
        metrics.update({k: v / cfg.updates
                        for k, v in zip(learner.metrics, sums)})
        return carry, metrics

    @torch.no_grad()
    def actor_fn(nets, obs_raw):
        return learner.actor(nets, prep(obs_raw))

    train_step.rollout, train_step.update = rollout, update
    train_step.graphs, train_step.rollout_len = graphs, T
    train_step.n_agents = n_agents
    train_step.actor_fn, train_step.actor_key = actor_fn, learner.actor_key
    return init_state, train_step
