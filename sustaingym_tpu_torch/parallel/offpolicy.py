"""The train step shared by the off-policy learners (``sac.py``, ``dqn.py``,
``ddpg.py``): the rollout into the replay ring and the loop of gradient
updates, eager or as CUDA graphs.

One train step, as the JAX package's one jitted program:

1. **rollout**: ``rollout_len`` steps of the env's batched ``step`` with
   autoreset at the steps that end every episode
   (:func:`core.env.phased_autoreset_step`), the actions drawn by the
   learner from the carried obs, the env states and flat obs carried from
   one train step to the next. Each step writes its transition into the
   ring: at the T-aligned block's slot (``replay.write_block``'s layout)
   when ``capacity % rollout_len == 0``, else at the next slot
   (``replay.write_transition``'s); ``done`` is broadcast over an agent
   axis before it is stored;
2. **updates**: ``updates`` times, ring slots drawn below ``min(written,
   capacity)`` (``replay.sample_transitions``) and one gradient update of
   the learner on them, its metrics summed on the device.

On a CUDA device (``capture`` None, the default) a rollout step is one of
two CUDA graphs (``core/graph.py``), with and without the reset,
replayed in the schedule's order, and one update is another, replayed
``updates`` times, each replay drawing its own slots and noise from the
registered generator. Each is captured at its first use. A rollout
graph restores the env buffers, its row counter and the guard after its
warm-up but not the ring: the warm-up writes the very slot that the
replay after it writes again, from the same inputs and generator state,
so no clone of the ring is made. ``written`` and DQN's ``iter`` advance
outside the graphs. The update's graph restores every network, target
and optimizer state. ``capture=False`` runs the same kernels eagerly.

The test hook: ``train_step(carry, generator, draws=...)`` takes the
draws prescribed (a list of tensors for each rollout step and for each
update, in the order the learner draws them) instead of drawing them from
the generator; it runs eagerly. Nothing on the main path passes it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..core import (ScheduleGuard, draw_env_rows, env_shard, flatten,
                    phased_autoreset_step, reset_schedule, tree_assign_,
                    tree_map)
from ..core.graph import Graphs, tree_leaves
from .ppo import _adam_state
from .replay import init_ring, ring_slots, sample_transitions

__all__ = ["Draws", "Reduce", "Learner", "make_off_policy_step",
           "check_gates", "polyak", "dense_init"]


class Draws:
    """The random draws of one rollout step or one update: from
    ``generator``, or, when ``prescribed`` (a list of tensors) is given,
    its tensors in order, each checked against the shape asked for. Each
    draw's env axis is ``env_axis`` (0 in the rollout, 1 in an update's
    (batch_per_env, num_envs, ...) batch); under ``core.env_shard`` it is
    drawn at the global size and this rank keeps its envs."""

    def __init__(self, generator: torch.Generator,
                 prescribed: list | None = None, env_axis: int = 0):
        self.generator = generator
        self.prescribed = None if prescribed is None else list(prescribed)
        self.axis = env_axis

    def _draw(self, fn, shape) -> torch.Tensor:
        """``fn(shape)`` with the env axis drawn globally."""
        shape, a = tuple(shape), self.axis
        return draw_env_rows(
            lambda b: fn(shape[:a] + (b,) + shape[a + 1:]), shape[a], a)

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
        return self._draw(lambda s: torch.randn(s, generator=g,
                                                device=g.device), shape)

    def randint(self, high: int, shape, device) -> torch.Tensor:
        """Integers in [0, high), int64."""
        if self.prescribed is not None:
            return self._next(shape, device, torch.long)
        g = self.generator
        return self._draw(lambda s: torch.randint(
            high, s, generator=g, device=g.device), shape)

    def mask(self, shape, p: torch.Tensor, device) -> torch.Tensor:
        """True with probability ``p`` (``u < p``, u ~ U[0, 1) float32)."""
        if self.prescribed is not None:
            return self._next(shape, device, torch.bool)
        g = self.generator
        return self._draw(lambda s: torch.rand(s, generator=g,
                                               device=g.device), shape) < p

    def slots(self, shape, written: torch.Tensor, capacity: int
              ) -> torch.Tensor:
        """Ring slots below ``min(written, capacity)``
        (``replay.ring_slots``); shared slots ((batch_per_env,)) have no
        env axis, so every rank draws the same ones."""
        if self.prescribed is not None:
            return self._next(shape, written.device, torch.long)
        g = self.generator

        def uniform(s):
            return torch.rand(s, generator=g, device=g.device)

        u = (uniform(tuple(shape)) if len(shape) <= self.axis
             else self._draw(uniform, shape))
        return ring_slots(u, written, capacity)


class Reduce:
    """An update's reductions on one rank: with ``mesh`` None the plain
    means; under a dp mesh a mean is the rank's sum over the global count
    (every rank holds the same number of envs), a term of the parameters
    alone 1 / dp of it, and :meth:`grads` sums the gradients over dp
    before an optimizer steps, so every rank takes the same step."""

    def __init__(self, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.dp > 1 else None

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return torch.mean(x)
        return x.sum() / (x.numel() * self.mesh.dp)

    def param(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else x / self.mesh.dp

    @torch.no_grad()
    def grads(self, params) -> None:
        if self.mesh is None:
            return
        params = [p for p in params if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        buf = self.mesh.dp_sum_(torch.cat([p.grad.reshape(-1)
                                           for p in params]))
        at = 0
        for p in params:
            p.grad.copy_(buf[at:at + p.numel()].view_as(p))
            at += p.numel()


@dataclasses.dataclass
class Learner:
    """What a learner adds to the shared train step."""
    metrics: tuple[str, ...]   # the update's metrics, in their order
    # (generator, obs_dim) -> the carry's networks, targets, optimizers
    init: Callable[[torch.Generator, int], dict]
    # (carry, flat obs, draws, epsilon) -> (ring action, env action)
    act: Callable[..., tuple[torch.Tensor, Any]]
    # (carry, batch, draws, reduce) -> the metrics of one update,
    # (len(metrics),); ``reduce`` a :class:`Reduce`
    update: Callable[[dict, dict, Draws, Reduce], torch.Tensor]
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
                         capture: bool | None = None, mesh=None):
    """Builds (init_state, train_step) of an off-policy learner (module
    docstring).

    ``init_state(generator) -> carry``: the learner's networks, targets and
    optimizers, the zeroed ring (``buffer``: obs, act, reward, next_obs,
    done), ``written`` (0-d int64), DQN's ``iter``, the envs' states and
    flat obs reset from ``generator``, the steps since their episodes
    began (``env_phase``, a CPU int64) and the reset schedule's guard
    (``reset_guard``). ``train_step(carry, generator,
    *, draws=None) -> (carry, metrics)`` advances the carry in place and
    returns 0-d metric tensors: ``mean_reward`` (over the rollout's steps,
    envs and agents), DQN's ``epsilon``, and the mean of each update
    metric over the updates. Its phases are attributes, for timing them
    apart: ``rollout(carry, generator)`` and ``update(carry, generator)``
    (the summed update metrics); and ``graphs`` (None without capture),
    ``captured`` (the phases captured), ``rollout_len``, ``n_agents``,
    ``check(carry)`` (reads the reset guard now; train steps read it one
    step late), ``actor_fn(networks,
    obs_raw)`` (the deterministic evaluation actions of raw batched obs)
    and ``actor_key`` (the carry's entry it takes).

    The rollout resets the envs only at the steps that end every episode
    (``core.env.reset_schedule``), as PPO's generic rollout does: on the
    card two one-step graphs, with and without the reset, replayed in the
    schedule's order, each writing its transition at ring slot ``base +
    counter``.

    ``mesh`` (``parallel/mesh.py``; the JAX package's ``shard_sac_carry``,
    which DQN and DDPG reuse): ``cfg.num_envs`` is the global batch, the
    env batch and the ring's env axis are split over dp (each rank holds
    ``num_envs / dp`` envs and their ring columns), every draw is made at
    the global size and each rank keeps its envs (``core.env_shard``;
    shared ring slots are the same on every rank), the losses are local
    sums over the global counts and the gradients are all-reduced over dp
    before each optimizer step (:class:`Reduce`), so targets and Polyak
    updates stay equal on every rank. The networks are replicated (mp
    splits none of them). ``capture`` as in ``ppo.make_train_step``: with
    more than one rank the update (its collectives) runs eagerly and
    ``capture=True`` raises."""
    ma = bool(getattr(env, "agent_axis", False))
    device = env_params.device
    multi = mesh is not None and mesh.size > 1
    if capture and multi:
        raise ValueError(
            f"capture=True with a mesh of {mesh.size} ranks: the update's "
            f"collectives cannot be captured; pass capture=None (the "
            f"rollout captured) or False")
    dp = 1 if mesh is None else mesh.dp
    if cfg.num_envs % dp:
        raise ValueError(f"num_envs={cfg.num_envs} not divisible by "
                         f"dp={dp}")
    B = cfg.num_envs // dp
    offset = 0 if mesh is None else mesh.d * B
    red = Reduce(mesh)
    obs_space = env.observation_space(env_params)
    T, cap = int(cfg.rollout_len), int(cfg.capacity)
    # no fixed length (or no FunctionalEnv protocol): reset every step
    ep_len = (env.episode_steps(env_params)
              if hasattr(env, "episode_steps") else None)
    block = cap % T == 0
    step = phased_autoreset_step(env)
    captured = ()
    if capture is not False and device.type == "cuda":
        captured = ("rollout",) if multi else ("rollout", "update")
    graphs = Graphs(device) if captured else None
    n_agents = int(env.action_space(env_params).shape[0]) if ma else 1
    held = {}        # the rollout's buffers, made at its first call

    def shard():
        if dp == 1:
            return contextlib.nullcontext()
        return env_shard(offset, B, cfg.num_envs)

    def prep(obs_raw) -> torch.Tensor:
        """The flat float32 obs: a view's (B, n_agents, D) as they are, a
        single-agent env's flattened."""
        if ma:
            return obs_raw.float()
        return flatten(obs_space, obs_raw, batch_dims=1)

    def init_state(generator: torch.Generator) -> dict:
        if graphs is not None:
            graphs.clear()           # the last carry's captures and pool
        with shard():
            states, ts = env.reset(env_params, generator, B)
        obs = prep(ts.obs)
        carry = learner.init(generator, obs.shape[-1])
        lead = tuple(obs.shape[:-1])   # (B,) or (B, n_agents)
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
        carry["env_phase"] = torch.zeros((), dtype=torch.long)
        carry["reset_guard"] = torch.zeros((), dtype=torch.long,
                                           device=device)
        return carry

    def ring_ids(carry: dict) -> tuple:
        return tuple(id(x) for x in tree_leaves(carry["buffer"])) + (
            id(carry["written"]),)

    def buffers(carry):
        """The env state and flat obs, the step's reward means, the row
        counter and DQN's epsilon, read and written in place by both
        one-step graphs."""
        if "bufs" not in held:
            held["bufs"] = {
                "env": tree_map(torch.clone, {"state": carry["env_states"],
                                              "obs": carry["obs"]}),
                "means": torch.empty(T, device=device),
                "counter": torch.zeros(1, dtype=torch.long, device=device),
                "eps": torch.zeros((), device=device)}
        bufs = held["bufs"]
        tree_assign_(bufs["env"], {"state": carry["env_states"],
                                   "obs": carry["obs"]})
        return bufs

    @torch.no_grad()
    def rollout_step(carry, generator, prescribed, bufs, reset):
        """One autoreset step, its transition written into the ring at
        slot ``base + counter``: the part of the rollout that a CUDA graph
        captures (one graph with the reset, one without)."""
        ring, written = carry["buffer"], carry["written"]
        env_now = bufs["env"]
        eps = bufs["eps"] if learner.epsilon is not None else None
        draws = Draws(generator, prescribed)
        ring_act, action = learner.act(carry, env_now["obs"], draws, eps)
        states, ts = step(env_params, env_now["state"], action, generator,
                          reset, carry["reset_guard"] if ep_len else None)
        next_obs = prep(ts.obs)
        reward, done = ts.reward, ts.done
        if done.ndim < reward.ndim:   # agent-axis rewards
            done = done.reshape(done.shape + (1,) * (
                reward.ndim - done.ndim)).expand(reward.shape)
        tr = {"obs": env_now["obs"], "act": ring_act, "reward": reward,
              "next_obs": next_obs, "done": done.float()}
        i = bufs["counter"]
        # a block starts at the T-aligned slot (replay.write_block); one
        # slot a step follows ``written`` around the ring
        base = (written % cap) // T * T if block else written % cap
        slot = (base + i) % cap
        for k, r in ring.items():
            r.index_copy_(0, slot, tr[k].to(r.dtype)[None])
        bufs["means"].index_copy_(0, i, reward.mean()[None])
        tree_assign_(env_now, {"state": states, "obs": next_obs})
        i.add_(1)
        return ()

    def rollout(carry: dict, generator: torch.Generator,
                draws: list | None = None) -> tuple:
        """The rollout phase: advances the carry's envs and ring; returns
        (mean_reward,) or, for DQN, (mean_reward, epsilon)."""
        with shard():
            bufs = buffers(carry)
            bufs["counter"].zero_()
            if learner.epsilon is not None:
                bufs["eps"].copy_(learner.epsilon(carry["iter"]))
                carry["iter"].add_(1)
            guard = carry["reset_guard"]
            state = tree_leaves(bufs["env"]) + [bufs["counter"], guard]
            phase = int(carry["env_phase"])
            for t, reset in enumerate(reset_schedule(ep_len, phase, T)):
                fn = partial(rollout_step, carry, generator,
                             None if draws is None else draws[t], bufs,
                             reset)
                if graphs is None or draws is not None:
                    fn()
                    continue
                key = (("rollout", reset, id(generator), id(bufs))
                       + ring_ids(carry)
                       + tuple(map(id, _weights(carry) + [guard])))
                graphs(key, fn, generators=(generator,), state=state,
                       slot=("rollout", reset))
        carry["written"].add_(T)
        carry["env_states"] = bufs["env"]["state"]
        carry["obs"] = bufs["env"]["obs"]
        if ep_len:
            carry["env_phase"].fill_((phase + T) % ep_len)
        out = (bufs["means"].mean(),)
        return out if learner.epsilon is None else out + (bufs["eps"],)

    def update_body(carry, generator, prescribed, sums):
        """One gradient update on ring slots drawn below ``written``, its
        metrics added to ``sums``."""
        draws = Draws(generator, prescribed, env_axis=1)
        envs = carry["buffer"]["reward"].shape[1]
        shape = ((cfg.batch_per_env, envs) if cfg.per_env_sample
                 else (cfg.batch_per_env,))
        idx = draws.slots(shape, carry["written"], cap)
        batch = sample_transitions(carry["buffer"], carry["written"], cap,
                                   cfg.batch_per_env,
                                   per_env_sample=cfg.per_env_sample, idx=idx)
        metrics = learner.update(carry, batch, draws, red)
        with torch.no_grad():
            sums.add_(metrics)
        return sums

    def update(carry: dict, generator: torch.Generator,
               draws: list | None = None) -> torch.Tensor:
        """The update phase: ``updates`` gradient updates; returns the
        sums of their metrics, (len(metrics),) (under dp, summed over the
        ranks: each rank's terms are its part of the global ones)."""
        sums = torch.zeros(len(learner.metrics), device=device)
        if graphs is None or draws is not None or "update" not in captured:
            with shard():
                for u in range(cfg.updates):
                    update_body(carry, generator,
                                None if draws is None else draws[u], sums)
            if mesh is not None:
                mesh.dp_sum_(sums)
            return sums
        state = _update_state(carry)
        key = (("update", id(generator)) + ring_ids(carry)
               + tuple(map(id, state)))
        return graphs(key, partial(update_body, carry, generator, None),
                      sums, generators=(generator,), state=state,
                      repeat=cfg.updates, slot="update")

    guard = ScheduleGuard(env, ep_len)

    def train_step(carry: dict, generator: torch.Generator, *,
                   draws: dict | None = None):
        roll = rollout(carry, generator,
                       None if draws is None else draws["rollout"])
        # copied out before the update's graph runs: the next rollout
        # replay rewrites the graph's outputs
        mean_reward = roll[0].clone()
        if multi:
            mean_reward = mesh.dp_sum_(mean_reward.reshape(1))[0] / dp
        metrics = {"mean_reward": mean_reward}
        if learner.epsilon is not None:
            metrics["epsilon"] = roll[1].clone()
        sums = update(carry, generator,
                      None if draws is None else draws["updates"])
        metrics.update({k: v / cfg.updates
                        for k, v in zip(learner.metrics, sums)})
        guard.push(carry["reset_guard"])
        return carry, metrics

    @torch.no_grad()
    def actor_fn(nets, obs_raw):
        return learner.actor(nets, prep(obs_raw))

    train_step.rollout, train_step.update = rollout, update
    train_step.graphs, train_step.rollout_len = graphs, T
    train_step.captured, train_step.mesh = captured, mesh
    train_step.check = lambda carry: guard.check()
    train_step.n_agents = n_agents
    train_step.actor_fn, train_step.actor_key = actor_fn, learner.actor_key
    return init_state, train_step
