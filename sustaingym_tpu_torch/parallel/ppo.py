"""PPO and A2C learner: ``sustaingym_tpu.parallel.ppo`` on one card.

One train step = one rollout of ``rollout_len`` steps, a re-scoring of
(logp, value) in one batched pass, GAE on ``reward * reward_scale``, and
clipped-PPO (or A2C) epochs over ``torch.randperm`` minibatches of all
T x B samples. The rollout goes one of three ways, as in the JAX package:

- **fused** (EVChargingEnv or BuildingEnv with ``obs_bf16``, in a
  configuration its kernel computes): the actor runs inside the env's
  policy-in-kernel rollout (``fused_policy_unroll``); the rollout and the
  learner score the SAME bf16 obs with the same bf16 operands
  (:func:`policy_apply_bf16`);
- **episodic** (otherwise, an env with a lockstep ``batch_unroll``:
  BuildingEnv, CogenEnv, DataCenterEnv, ElectricityMarketEnv): the
  sampling policy applies the f32 :func:`policy_apply` to the flat obs and
  draws ``u`` from the generator: a Gaussian squashed into the Box action
  space, or, for a Discrete or MultiDiscrete action space, the bins of a
  categorical head (uniform bins, as the JAX package requires). The obs it
  saw (bf16 if ``obs_bf16``) and ``u`` are recorded and re-scored
  afterwards;
- **generic** (a rollout length other than the episode's, or an env
  with neither): the same sampling over the env's batched ``step`` with
  autoreset (:func:`core.env.capturable_autoreset_step`), the env states
  and obs carried from one train step to the next, and GAE bootstrapped
  from the value of the last obs.

The first two roll whole episodes from fresh resets and terminate on their
last step (no bootstrap value).

The multi-agent views (``envs/multiagent.py``, ``env.agent_axis``) train
one of four ways, as in the JAX package:

- **agent axis as batch** (MA-EV with ``periods_delay`` > 0 on the
  episodic path through the view's ``batch_unroll``; MA building on the
  generic path): one shared policy over the (B, n_agents, D) obs as they
  are, each agent's action width, ``done`` broadcast over the agent axis
  before GAE, minibatch rows (t, env, agent);
- **uniform obs** (``uma``: MA-EV with ``periods_delay == 0`` and
  continuous actions, whose agents all see one obs row): the base env's
  lockstep rollout, the trunk run once for each (env, t), ``u`` drawn for
  each agent around the shared ``mu`` ((B, n_agents) noise), the reward /
  n_agents; rows (t, env) with ``u`` and ``logp`` (rows, n_agents) and the
  advantage broadcast over the agents. It equals the agent-axis path's
  step. (The JAX package's gate ignores a caller's ``obs_fn`` /
  ``act_transform``; :func:`make_train_step` takes neither, and a gate
  that ever does must refuse them.);
- **per-agent stacked policies** (``env.per_agent_policy``: MA cogen, on
  the generic path): one policy per agent, every weight with a leading
  (n_agents,) axis (:class:`StackedActorCritic`,
  :func:`per_agent_apply`), the Gaussian log-prob masked by the env's
  ``action_pad_mask``, the entropy ``sum(mask * terms) / n_agents``, the
  action squashed into ``padded_action_space``; rows (t, env) carrying
  the whole agent axis;
- **discrete** (MA-EV ``discrete_bins``): the categorical head over
  (n_agents, bins) logits, on the generic path.

Either way, with lr=0 every ratio is exactly 1 (the exact-ratio invariant
of the JAX package's tests); on a CUDA device the Gaussian heads that
:func:`loss_fn` runs as one kernel pass sum the log-prob in another order
than the scoring, so there the ratio is 1 up to float32 rounding.

On a CUDA device a train step is the counterpart of the JAX package's one
jitted program: the rollout's step loop (an episode's, or the generic
rollout's ``rollout_len`` steps), the re-scoring with GAE, and each
minibatch update (gather, forward, backward, global-norm clip, Adam) are
CUDA graphs (``core/graph.py``), captured at the first train step and
replayed after. ``make_train_step(..., capture=False)`` builds the same
step without graphs, for comparisons.

With a ``mesh`` (``parallel/mesh.py``) the env batch is split over the dp
ranks and the MLP's hidden over the mp ranks, as the JAX package's
``carry_shardings`` lays them out (:func:`make_train_step`,
:func:`shard_policy`).
"""
from __future__ import annotations

import contextlib
import math
import warnings
from functools import partial

import numpy as np
import torch
from torch import nn

from ..core import (Discrete, MultiDiscrete, ScheduleGuard, dataclass,
                    draw_env_rows, env_shard, flatdim, flatten,
                    phased_autoreset_step, reset_schedule, tree_assign_,
                    tree_map)
from ..core import trace
from ..core.graph import Graphs, device_const, tree_leaves
from ..ops.cuda.ppo_loss import fused_ppo_loss
from ..ops.cuda.ppo_trunk import ppo_trunk
from .mesh import Mesh, mp_all_reduce

__all__ = ["PPOConfig", "ActorCritic", "StackedActorCritic", "init_policy",
           "init_stacked_policy", "policy_apply", "policy_apply_bf16",
           "policy_apply_bf16_ref",
           "per_agent_apply", "default_act_transform", "gae", "fused_head",
           "loss_fn",
           "clip_by_global_norm", "make_train_step"]

METRICS = ("pg_loss", "vf_loss", "entropy")


@dataclass
class PPOConfig:
    """``rollout_len`` steps a rollout; None is the env's
    ``episode_steps``, a whole episode per env."""
    num_envs: int = 256
    rollout_len: int | None = None
    # the trunk's width; where the bf16 trunk runs on the card
    # (``obs_bf16``'s fused path) a multiple of 8 from 8 to 2048, the
    # widths ``ops/cuda/ppo_trunk.py``'s passes take (others raise there)
    hidden: int = 256
    epochs: int = 4
    minibatches: int = 8
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    # multiplies rewards before GAE/returns (reported metrics stay
    # unscaled); envs with |reward| >> 1 (cogen's 1e4-1e5 penalty scale)
    # need ~1/|r| here, or the value-loss gradient drowns the policy
    # gradient under the shared global-norm clip
    reward_scale: float = 1.0
    # store observations in bfloat16: the rollout, the behaviour logp and
    # every update epoch score the SAME bf16 values. Required by the fused
    # EV path, whose kernel writes a bf16 learner block
    obs_bf16: bool = False
    # "ppo" (clipped ratio) or "a2c" (-(logp * adv).mean(), same learner)
    algo: str = "ppo"


class ActorCritic(nn.Module):
    """Diag-Gaussian tanh MLP actor-critic over flat observations (the
    JAX package's trunk1/trunk2/mu/value/log_std policy tree). With a
    categorical head ``mu`` holds the logits, act_dim x n_bins wide."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256,
                 device=None):
        super().__init__()
        self.trunk1 = nn.Linear(obs_dim, hidden, device=device)
        self.trunk2 = nn.Linear(hidden, hidden, device=device)
        self.mu = nn.Linear(hidden, act_dim, device=device)
        self.value = nn.Linear(hidden, 1, device=device)
        self.log_std = nn.Parameter(
            torch.full((act_dim,), -0.5, device=device))


@torch.no_grad()
def init_policy(obs_dim: int, act_dim: int, hidden: int,
                generator: torch.Generator, device=None) -> ActorCritic:
    """He-normal weights (N(0, 2/din)) drawn from ``generator``, zero
    biases, log_std = -0.5."""
    policy = ActorCritic(obs_dim, act_dim, hidden, device=device)
    for layer in (policy.trunk1, policy.trunk2, policy.mu, policy.value):
        dout, din = layer.weight.shape
        w = torch.randn((din, dout), generator=generator,
                        device=generator.device)
        layer.weight.copy_((w * math.sqrt(2.0 / din)).t())
        layer.bias.zero_()
    return policy


class _StackedLinear(nn.Module):
    """A dense layer for each agent: ``weight`` (n_agents, din, dout), in
    the JAX tree's orientation, and ``bias`` (n_agents, dout)."""

    def __init__(self, n_agents: int, din: int, dout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n_agents, din, dout),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros((n_agents, dout),
                                             device=device))


class StackedActorCritic(nn.Module):
    """One :class:`ActorCritic` per agent, stacked: every weight has a
    leading (n_agents,) axis (the JAX package's vmapped policy tree)."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int,
                 hidden: int = 256, device=None):
        super().__init__()
        self.trunk1 = _StackedLinear(n_agents, obs_dim, hidden, device)
        self.trunk2 = _StackedLinear(n_agents, hidden, hidden, device)
        self.mu = _StackedLinear(n_agents, hidden, act_dim, device)
        self.value = _StackedLinear(n_agents, hidden, 1, device)
        self.log_std = nn.Parameter(
            torch.full((n_agents, act_dim), -0.5, device=device))


@torch.no_grad()
def init_stacked_policy(n_agents: int, obs_dim: int, act_dim: int,
                        hidden: int, generator: torch.Generator,
                        device=None) -> StackedActorCritic:
    """:func:`init_policy` for each agent: He-normal weights from
    ``generator``, zero biases, log_std = -0.5."""
    policy = StackedActorCritic(n_agents, obs_dim, act_dim, hidden,
                                device=device)
    for layer in (policy.trunk1, policy.trunk2, policy.mu, policy.value):
        din = layer.weight.shape[1]
        w = torch.randn(tuple(layer.weight.shape), generator=generator,
                        device=generator.device)
        layer.weight.copy_(w * math.sqrt(2.0 / din))
    return policy


def per_agent_apply(policy: StackedActorCritic, obs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """obs (..., n_agents, obs_dim) f32 -> (mu (..., n_agents, act_dim),
    log_std (n_agents, act_dim), value (..., n_agents)): each agent's
    slice through its own weights, one batched product a layer."""
    h = torch.tanh(torch.einsum("...ad,adh->...ah", obs, policy.trunk1.weight)
                   + policy.trunk1.bias)
    z = torch.einsum("...ah,ahk->...ak", h, policy.trunk2.weight)
    h = torch.tanh(mp_all_reduce(z, getattr(policy, "mp_group", None))
                   + policy.trunk2.bias)
    mu = torch.einsum("...ah,ahm->...am", h, policy.mu.weight) + policy.mu.bias
    value = (torch.einsum("...ah,ahv->...av", h, policy.value.weight)
             + policy.value.bias)[..., 0]
    return mu, policy.log_std, value


# the mp split (the JAX package's carry_shardings, Megatron form): trunk1
# column-parallel (its output hidden), trunk2 row-parallel (its input
# hidden); the axis of each in a torch Linear's (dout, din) weight and in
# the stacked (n_agents, din, dout) one, whose agent axis is never split
_MP_AXES = {False: {("trunk1", "weight"): 0, ("trunk1", "bias"): 0,
                    ("trunk2", "weight"): 1},
            True: {("trunk1", "weight"): -1, ("trunk1", "bias"): -1,
                   ("trunk2", "weight"): -2}}


def _mp_axes(policy: nn.Module) -> dict:
    return _MP_AXES[isinstance(policy, StackedActorCritic)]


def mp_param_axes(policy: nn.Module) -> dict:
    """{parameter: (state-dict name, sharded axis)} of the mp split
    (empty without one, or for a module that is not a PPO policy)."""
    if getattr(policy, "mp_group", None) is None:
        return {}
    return {getattr(getattr(policy, layer), attr): (f"{layer}.{attr}", axis)
            for (layer, attr), axis in _mp_axes(policy).items()}


@torch.no_grad()
def shard_policy(policy: nn.Module, mesh: Mesh | None) -> nn.Module:
    """Splits ``policy`` (``ActorCritic`` or ``StackedActorCritic``) over
    ``mesh``'s mp group in place, Megatron style: trunk1's output hidden
    and trunk2's input hidden keep this rank's 1 / mp; the heads and
    ``log_std`` stay whole. Nothing changes without a split. Make the
    optimizer after it: its state follows the shards."""
    if mesh is None or mesh.mp == 1:
        return policy
    for (layer, attr), axis in _mp_axes(policy).items():
        mod = getattr(policy, layer)
        setattr(mod, attr, nn.Parameter(
            mesh.model_shard(getattr(mod, attr).detach(), axis)))
    policy.mp_group = mesh.mp_group
    return policy


@torch.no_grad()
def unsharded_state(policy: nn.Module, mesh: Mesh | None) -> dict:
    """``policy``'s state dict with the mp shards gathered: the one-rank
    format (every mp rank calls it; checkpoints)."""
    state = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    for key, axis in mp_param_axes(policy).values():
        state[key] = mesh.unshard(state[key], axis)
    return state


def policy_apply(policy: ActorCritic, obs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """obs (..., obs_dim) f32 -> (mu, log_std, value), all f32. Under an
    mp split (:func:`shard_policy`) trunk1 is column-parallel and trunk2
    row-parallel: its partial sums are all-reduced over the mp group
    before the bias."""
    h = torch.tanh(obs @ policy.trunk1.weight.t() + policy.trunk1.bias)
    z = h @ policy.trunk2.weight.t()
    h = torch.tanh(mp_all_reduce(z, getattr(policy, "mp_group", None))
                   + policy.trunk2.bias)
    mu = h @ policy.mu.weight.t() + policy.mu.bias
    value = (h @ policy.value.weight.t() + policy.value.bias)[..., 0]
    return mu, policy.log_std, value


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def policy_apply_bf16_ref(policy: ActorCritic, obs: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version of :func:`policy_apply_bf16`: the bf16-valued
    operands multiplied in float32 (full float32: no TF32). The CPU's
    route."""
    h = torch.tanh(obs.float() @ _bf(policy.trunk1.weight).t()
                   + policy.trunk1.bias)
    h = torch.tanh(_bf(h) @ _bf(policy.trunk2.weight).t()
                   + policy.trunk2.bias)
    h = _bf(h)
    mu = h @ _bf(policy.mu.weight).t() + policy.mu.bias
    value = (h @ _bf(policy.value.weight).t() + policy.value.bias)[..., 0]
    return mu, policy.log_std, value


def policy_apply_bf16(policy: ActorCritic, obs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu, log_std, value) from bf16 obs with bf16 weights and hidden
    activations and f32 accumulation — the kernel actor's numerics, used
    for both the rollout's scoring and every update. On a CUDA device the
    three products (obs x trunk1, h1 x trunk2, h2 x [mu; value]) are bf16
    GEMMs with float32 output, each weight cast to bf16 once, and the
    elementwise glue between them (bias, tanh, bf16 rounding and, in the
    backward, tanh's gradient, the bias gradients and the float32 copies
    of the bf16 operands) is one hand-written pass a hidden layer and
    direction (``ops/cuda/ppo_trunk.py``, :func:`ppo_trunk`, which raises
    for a width it cannot take); ``mu`` and ``value`` are the two parts of
    the last product plus its biases (views). Elsewhere
    :func:`policy_apply_bf16_ref`."""
    if obs.device.type != "cuda":
        return policy_apply_bf16_ref(policy, obs)
    return _apply_trunk(policy, obs)


def _apply_trunk(policy: ActorCritic, obs: torch.Tensor):
    """:func:`policy_apply_bf16`'s card route on any device (on the CPU
    :func:`ppo_trunk` runs its passes' plain versions)."""
    bf = torch.bfloat16
    x = obs.to(bf)
    # both heads in one product: the hidden gradient is summed in float32
    # before its bf16 rounding, as the plain version sums it
    heads = torch.cat([policy.mu.weight, policy.value.weight]).to(bf)
    out = ppo_trunk(x.reshape(-1, x.shape[-1]),
                    policy.trunk1.weight.to(bf), policy.trunk1.bias,
                    policy.trunk2.weight.to(bf), policy.trunk2.bias, heads)
    out = out.reshape(x.shape[:-1] + out.shape[-1:]) + torch.cat(
        [policy.mu.bias, policy.value.bias])
    # mu and value stay views of the one product: the fused loss head
    # (:func:`loss_fn`) reads them in place and returns its gradient whole
    act_dim = policy.mu.weight.shape[0]
    return out[..., :act_dim], policy.log_std, out[..., act_dim]


def _gauss_logp(mu, log_std, a, mask=None):
    """Diagonal-Gaussian log-prob, summed over the last axis; ``mask``
    (broadcast over the last axis) zeroes padded action components, so they
    add neither density nor gradient."""
    var = torch.exp(2 * log_std)
    terms = -0.5 * ((a - mu) ** 2 / var + 2 * log_std
                    + math.log(2 * math.pi))
    if mask is not None:
        terms = terms * mask
    return torch.sum(terms, -1)


def _uma_logp(mu, log_std, u):
    """The uniform-obs path's per-agent log-prob: ``u`` (..., n_agents)
    drawn around the shared ``mu`` (..., 1), one action each; the JAX
    package's formula, not summed over the agents."""
    return -0.5 * ((u - mu) ** 2 * torch.exp(-2 * log_std) + 2 * log_std
                   + math.log(2 * math.pi))


def _categorical_logp(logits, idx):
    """Sum over action dims of log softmax(logits) at the chosen bins.
    logits (..., act_dim, n_bins), idx (..., act_dim) int."""
    logp = torch.log_softmax(logits, -1)
    return torch.sum(torch.gather(logp, -1, idx[..., None].long())[..., 0],
                     -1)


def _categorical_entropy(logits):
    """Entropy summed over action dims, logits (..., act_dim, n_bins)."""
    logp = torch.log_softmax(logits, -1)
    return -torch.sum(torch.exp(logp) * logp, (-2, -1))


def _sample_categorical(logits, generator):
    """Bins drawn by the Gumbel-max rule, as ``jax.random.categorical``:
    argmax(logits - log(-log U)), U ~ U[tiny, 1) from ``generator``."""
    shape = logits.shape
    u = draw_env_rows(lambda b: torch.rand(
        (b,) + shape[1:], generator=generator, device=generator.device),
        shape[0])
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), -1)


def default_act_transform(env, params, space=None):
    """Maps the policy's unbounded output to the env's Box action space by
    tanh squashing (the kernel bakes in Box(0, 1)); ``space`` overrides the
    env's (the padded per-agent layout)."""
    space = env.action_space(params) if space is None else space

    def fn(u):
        lo = device_const(space.low, u.device)
        hi = device_const(space.high, u.device)
        return lo + (torch.tanh(u) * 0.5 + 0.5) * (hi - lo)

    return fn


def gae(cfg: PPOConfig, value, reward, done, last_value):
    """Generalized advantage estimation over (T, B); returns (adv, ret)."""
    advs = torch.empty_like(value)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(value.shape[0] - 1, -1, -1):
        nonterm = 1.0 - done[t].to(reward.dtype)
        delta = reward[t] + cfg.gamma * v_next * nonterm - value[t]
        adv_next = delta + cfg.gamma * cfg.lam * nonterm * adv_next
        advs[t] = adv_next
        v_next = value[t]
    return advs, advs + value


def _apply_f32(policy: ActorCritic, obs: torch.Tensor):
    """:func:`policy_apply` on obs stored as f32 or bf16."""
    return policy_apply(policy, obs.float())


def _apply_stacked_f32(policy: StackedActorCritic, obs: torch.Tensor):
    """:func:`per_agent_apply` on obs stored as f32 or bf16."""
    return per_agent_apply(policy, obs.float())


def _logits(mu: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The categorical head's (..., act_dim, n_bins) logits."""
    return mu.reshape(mu.shape[:-1] + (-1, n_bins))


class DpReduce:
    """A dp rank's reductions over one global minibatch of ``count`` rows,
    this rank holding some of them: a mean is the local sum over the
    global count, a term of the parameters alone (the Gaussian entropy)
    is 1 / dp of it on every rank, and the advantages are normalised by
    the global minibatch's mean and population std (all-reduced sums, two
    passes). Summed over the dp group each equals the one-rank value up
    to the order of the sums."""

    def __init__(self, mesh: Mesh, count: int):
        self.mesh, self.count = mesh, count

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum() / (self.count * math.prod(x.shape[1:]))

    def param_term(self, x: torch.Tensor) -> torch.Tensor:
        return x / self.mesh.dp

    def normalize(self, adv: torch.Tensor) -> torch.Tensor:
        # over every element: a stacked policy's rows carry their agents
        n = self.count * math.prod(adv.shape[1:])
        mean = self.mesh.dp_sum_(adv.sum().reshape(1)) / n
        dev = adv - mean
        var = self.mesh.dp_sum_((dev * dev).sum().reshape(1)) / n
        return dev / (torch.sqrt(var) + 1e-8)


def fused_head(mu: torch.Tensor, cfg: PPOConfig, n_bins: int = 0,
               mask=None, uma: bool = False,
               red: DpReduce | None = None) -> bool:
    """Whether :func:`loss_fn` runs its head as the fused kernel pass: a
    Gaussian head (``n_bins`` 0) without mask, not the uniform-obs path, on
    one rank, clipped PPO, with ``mu`` on a CUDA device."""
    return (mu.device.type == "cuda" and not n_bins and mask is None
            and not uma and red is None and cfg.algo == "ppo")


def loss_fn(policy: ActorCritic, batch: dict, cfg: PPOConfig,
            apply=policy_apply_bf16, n_bins: int = 0, mask=None,
            uma: bool = False, red: DpReduce | None = None):
    """Clipped-PPO (or, with ``cfg.algo == "a2c"``, A2C) loss on one
    minibatch, scored by ``apply`` (the same function that scored the
    rollout), with a Gaussian head or, for ``n_bins`` > 0, a categorical
    one; returns (loss, {pg_loss, vf_loss, entropy}). ``mask``
    (n_agents, act_dim): per-agent stacked policies, padded components
    masked out of the log-prob and the entropy, which is summed over the
    real components and divided by n_agents. ``uma``: the uniform-obs
    path's rows, ``u`` and ``logp`` (rows, n_agents) around one ``mu``,
    each row's advantage broadcast over its agents. ``red``: a dp rank's
    share of a global minibatch (:class:`DpReduce`); each returned term
    is then this rank's part of the global one.

    A Gaussian head without mask on one rank, clipped PPO, on a CUDA
    device runs as one hand-written kernel pass, forward and gradient
    together (``ops/cuda/ppo_loss.py``, :func:`fused_ppo_loss`, which
    raises for head outputs it cannot take); every other head and any CPU
    tensor runs the autograd chain below."""
    mean = torch.mean if red is None else red.mean
    param = (lambda x: x) if red is None else red.param_term
    mu, log_std, value = apply(policy, batch["obs"])
    if fused_head(mu, cfg, n_bins, mask, uma, red):
        loss, pg, vf, ent = fused_ppo_loss(
            mu, log_std, value, batch["u"], batch["logp"], batch["adv"],
            batch["ret"], cfg.clip_eps, cfg.vf_coef, cfg.ent_coef)
        return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}
    ent_terms = log_std + 0.5 * math.log(2 * math.pi * math.e)
    if n_bins:
        logits = _logits(mu, n_bins)
        logp = _categorical_logp(logits, batch["u"])
        ent = mean(_categorical_entropy(logits))
    elif uma:
        logp = _uma_logp(mu, log_std, batch["u"])
        ent = param(torch.sum(ent_terms))
    elif mask is not None:
        logp = _gauss_logp(mu, log_std, batch["u"], mask)
        ent = param(torch.sum(mask * ent_terms) / mask.shape[0])
    else:
        logp = _gauss_logp(mu, log_std, batch["u"])
        ent = param(torch.sum(ent_terms))
    adv = batch["adv"]
    if red is None:
        # population std, as jnp.std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    else:
        adv = red.normalize(adv)
    if uma:
        adv = adv[:, None]
    if cfg.algo == "a2c":
        pg = -mean(logp * adv)
    else:
        ratio = torch.exp(logp - batch["logp"])
        pg = -mean(torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv))
    vf = 0.5 * mean((value - batch["ret"]) ** 2)
    loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float, mesh: Mesh | None = None,
                        sharded=()) -> torch.Tensor:
    """optax.clip_by_global_norm: g <- g / norm * max_norm where
    norm >= max_norm (no epsilon, unlike ``clip_grad_norm_``). Returns the
    norm; never synchronises with the device. Under an mp split each
    parameter counts once: the replicated ones locally, the ``sharded``
    ones' squares summed over the mp group."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is None or mesh.mp == 1:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    else:
        ids = {id(p) for p in sharded}
        held = [p for p in params if p.grad is not None]
        rep = sum(torch.sum(p.grad * p.grad) for p in held
                  if id(p) not in ids)
        own = sum(torch.sum(p.grad * p.grad) for p in held if id(p) in ids)
        norm = torch.sqrt(rep + mesh.mp_sum_(own.reshape(1))[0])
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """optax.adam(lr) as ``torch.optim.Adam``; on a CUDA device its
    capturable foreach form, whose step count lives on the card, for the
    captured update and the eager one alike."""
    if device.type == "cuda":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, capturable=True, foreach=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _adam(params, cfg: PPOConfig, device: torch.device):
    """:func:`adam` at ``cfg.lr``."""
    return adam(params, cfg.lr, device)


def _adam_state(opt: torch.optim.Adam) -> list[torch.Tensor]:
    """The tensors of ``opt``'s state, made first (zeros, as its first
    step makes them) where a parameter has none yet: the captured update
    binds them, and a warm-up restores them."""
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32,
                                         device=p.device)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


def _action_head(space, per_agent: bool = False) -> tuple[int, int]:
    """(act_dim, n_bins) of ``space``: n_bins 0 for a Box; for a Discrete
    or MultiDiscrete space one categorical of n_bins per action dim, which
    must all be equal and at least 2 (the JAX package's check). With
    ``per_agent`` (an agent-axis view) the space's leading axis is the
    agents' and act_dim is each agent's."""
    if not isinstance(space, (Discrete, MultiDiscrete)):
        return (int(space.shape[-1]) if per_agent else flatdim(space)), 0
    nvec = (np.asarray([space.n]) if isinstance(space, Discrete)
            else np.asarray(space.nvec))
    if not np.all(nvec == nvec.flat[0]):
        raise ValueError(
            f"categorical PPO needs uniform bins, got nvec={nvec}")
    n_bins = int(nvec.flat[0])
    if n_bins < 2:
        raise ValueError(f"categorical PPO needs >= 2 bins, got {n_bins}")
    return (int(nvec.shape[-1]) if per_agent else int(nvec.size)), n_bins


def _sampler(prep, apply, act, n_bins: int, agents: int = 0):
    """``sample(policy, obs_raw, generator) -> (obs, u, action)``: the obs
    ``prep(obs_raw)`` (flat, in its storage dtype), ``apply`` and ``u``
    drawn from the generator: Gaussian, squashed into the action by
    ``act``, or the bins of a categorical head when ``n_bins``. With
    ``agents`` (the uniform-obs path), ``u`` is (B, agents), each agent's
    draw around the one ``mu`` (B, 1)."""

    def sample(policy, obs_raw, generator):
        obs = prep(obs_raw)
        mu, log_std, _ = apply(policy, obs)
        if n_bins:
            u = _sample_categorical(_logits(mu, n_bins), generator)
            return obs, u, u
        shape = mu.shape[:-1] + (agents,) if agents else mu.shape
        u = mu + torch.exp(log_std) * draw_env_rows(lambda b: torch.randn(
            (b,) + shape[1:], generator=generator, device=generator.device),
            shape[0])
        if agents:
            return obs, u, act(u[..., None])[..., 0]
        return obs, u, act(u)

    return sample


class _SamplingPolicy:
    """The episodic rollout's policy, built once per trainer and policy:
    draws by ``sample`` (:func:`_sampler`) and records the obs and ``u`` of
    step t in row t of ``obs`` / ``u`` (steps, B, ...), which it allocates
    at step 0. Inside a captured episode the rows are the graph's outputs,
    rewritten by each replay."""

    def __init__(self, sample, steps: int):
        self.sample, self.steps = sample, steps
        self.t = 0
        self.obs = self.u = None

    def __call__(self, policy, obs_raw, generator):
        obs, u, action = self.sample(policy, obs_raw, generator)
        if self.t == 0:
            self.obs = obs.new_empty((self.steps,) + obs.shape)
            self.u = u.new_empty((self.steps,) + u.shape)
        self.obs[self.t] = obs
        self.u[self.t] = u
        self.t = (self.t + 1) % self.steps
        return action


def make_train_step(env, env_params, cfg: PPOConfig,
                    capture: bool | None = None, mesh: Mesh | None = None,
                    path: str | None = None):
    """Builds (init_state, train_step).

    ``init_state(generator) -> carry`` with the policy and its Adam state,
    and for the generic rollout the envs' states and obs (``env_states``,
    ``obs``: reset from ``generator``, carried across train steps), the
    steps since their episodes began (``env_phase``, a CPU int64) and the
    reset schedule's guard (``reset_guard``);
    ``train_step(carry, generator) -> (carry, metrics)`` runs one rollout +
    update in place on the params' device and returns 0-d metric tensors
    (no host synchronisation). Its three phases are also attributes of
    ``train_step``, for timing them apart: ``rollout(policy, generator,
    carry) -> out`` (the generic rollout reads and advances the carry's
    envs; the others need no carry), ``score(policy, out) -> samples``
    (re-scoring and GAE) and ``update(policy, opt, samples, generator) ->
    summed metrics``; and
    ``train_step.graphs``, the trainer's :class:`core.graph.Graphs` (None
    without capture), ``train_step.captured`` (the phases captured),
    ``train_step.path`` ("fused", "episodic" or
    "generic"), ``train_step.uma`` (the uniform-obs multi-agent path),
    ``train_step.per_agent`` (per-agent stacked policies),
    ``train_step.n_agents`` (1 for a single-agent env),
    ``train_step.rollout_len``, ``train_step.check(carry)`` (reads the
    generic rollout's reset guard now; train steps read it one step late)
    and ``train_step.actor(policy, obs) ->
    actions``, the deterministic evaluation policy (also ``actor_fn``,
    with ``actor_key`` "policy": the evaluation hooks of every learner).

    With ``cfg.rollout_len`` the episode length (or None), the rollout is
    the fused path when ``cfg.obs_bf16``, the env has a
    ``fused_policy_unroll`` and ``env.fused_policy_unroll_supported(params,
    num_envs)``; else the episodic path when the env has a lockstep
    ``batch_unroll`` (not for per-agent policies, nor for a discrete
    multi-agent view); else, and at any other length, the generic path,
    which needs the env's batched ``step`` and ``reset`` (module
    docstring, which also lists the multi-agent paths). ``path``, if
    given, must be the one this resolves to, else a ``ValueError`` says
    why it is not.

    The generic rollout resets the envs only at the steps that end every
    episode (``core.env.reset_schedule`` from ``env_phase``; every step
    where the env has no fixed ``episode_steps``), and counts in
    ``reset_guard`` the steps where the envs broke that schedule: a count
    other than 0 raises at the next read.

    ``mesh`` (``parallel/mesh.py``): ``cfg.num_envs`` is the global batch,
    each dp rank rolls out its ``num_envs / dp`` envs (every draw at the
    global size, ``core.env_shard``; the kernels' streams keyed by the
    global env index), scores them and computes their GAE, and the
    update equals the one-rank update of the global batch up to the order
    of the sums: every rank draws the global permutations, takes the rows
    of each global minibatch that it holds (no batch moves between
    ranks), and the loss's means are its sums over the global count
    (:class:`DpReduce`); the gradients and metrics are all-reduced over
    dp before the clip, so Adam keeps the parameters equal on every rank.
    With mp > 1 the policy is split (:func:`shard_policy`); the fused
    kernels need whole weights, so the path resolves as the JAX gate
    does on a multi-device mesh (``path="fused"`` raises).

    On a CUDA device the phases run as CUDA graphs captured at the first
    train step (never here: a checkpoint restored after ``init_state``
    replaces the optimizer state they bind): the rollout's step loop (the
    episodic path's episode, the generic path's one-step graphs with and
    without the reset, replayed in the schedule's order, each writing its
    trajectory row at a device counter), the scoring and each minibatch
    update. A phase holds one graph: another policy or optimizer state
    (a carry made earlier, ``opt.load_state_dict``) replaces it, and
    ``init_state`` drops them all with their memory pool.
    What a phase returns is then the graph's output, rewritten when that
    phase runs again. ``capture`` None captures what the mesh allows:
    with more than one rank the update and the metrics' reduction hold
    collectives (gloo cannot be captured) and run eagerly, and with mp >
    1 the rollout and scoring too; ``capture=True`` asks for the whole
    step and raises with more than one rank; ``capture=False`` runs the
    same step eagerly (for comparisons). On the CPU every step is
    eager."""
    if cfg.algo not in ("ppo", "a2c"):
        raise ValueError(f"unknown on-policy algo {cfg.algo!r}")
    multi = mesh is not None and mesh.size > 1
    if capture and multi:
        raise ValueError(
            f"capture=True with a mesh of {mesh.size} ranks: the update's "
            f"collectives cannot be captured; pass capture=None (the "
            f"rollout and scoring captured where they hold none) or False")
    dp = 1 if mesh is None else mesh.dp
    mp = 1 if mesh is None else mesh.mp
    if cfg.num_envs % dp:
        raise ValueError(f"num_envs={cfg.num_envs} not divisible by "
                         f"dp={dp}")
    B = cfg.num_envs // dp            # this rank's envs
    offset = 0 if mesh is None else mesh.d * B
    ep_len = env.episode_steps(env_params)
    T = ep_len if cfg.rollout_len is None else int(cfg.rollout_len)
    if not T or T < 1:
        raise ValueError(f"rollout_len {T!r}: pass a positive length (the "
                         f"env has no fixed episode length)")
    whole = T == ep_len
    # multi-agent views: obs (B, n_agents, D) already flat; a shared
    # policy takes the agent axis as batch, act_dim is each agent's
    ma = bool(getattr(env, "agent_axis", False))
    pap = bool(getattr(env, "per_agent_policy", False))
    # the fused kernels compute Box actions only: their
    # fused_policy_unroll_supported is False for a discrete space; they
    # need the whole weights, so an mp split turns them off (the JAX
    # gate's single-device term); under dp each rank runs them on its own
    fused_env = (not ma and whole and cfg.obs_bf16
                 and hasattr(env, "fused_policy_unroll")
                 and env.fused_policy_unroll_supported(env_params, B))
    fused = fused_env and mp == 1
    # a discrete view and per-agent policies take the generic path, as in
    # the JAX package
    episodic = (whole and hasattr(env, "batch_unroll") and not pap
                and not (ma and isinstance(env.action_space(env_params),
                                           (Discrete, MultiDiscrete))))
    # uniform-obs multi-agent path (continuous, as episodic implies for a
    # view): every agent's obs row is the same, so the trunk runs once for
    # each (env, t). make_train_step takes no obs_fn / act_transform; a
    # gate that ever does must refuse them
    uma = (ma and episodic
           and getattr(env, "uniform_agent_obs", None) is not None
           and env.uniform_agent_obs(env_params))
    resolved = "fused" if fused else "episodic" if episodic else "generic"
    if path is not None and path != resolved:
        why = (f"the fused policy kernels need the whole weights; mp={mp} "
               f"splits them" if path == "fused" and fused_env else
               "see make_train_step's docstring for each path's gate")
        raise ValueError(f"path={path!r} asked for, this configuration "
                         f"resolves to {resolved!r}: {why}")
    path = resolved
    if path == "generic" and not (hasattr(env, "step")
                                  and hasattr(env, "reset")):
        raise ValueError(
            f"{type(env).__name__}: PPO needs the env's batched step and "
            f"reset (generic rollout), a lockstep batch_unroll (episodic) "
            f"or a fused_policy_unroll (fused, obs_bf16)")
    device = env_params.device
    mask = None
    if pap:
        space = env.padded_action_space(env_params)
        if isinstance(space, (Discrete, MultiDiscrete)):
            raise ValueError("per-agent policies with discrete actions are "
                             "not supported")
        n_agents, act_dim = (int(x) for x in space.shape)
        n_bins = 0
        mask = device_const(env.action_pad_mask(), device)
    else:
        space = env.action_space(env_params)
        act_dim, n_bins = _action_head(space, per_agent=ma)
        n_agents = int(space.shape[0]) if ma else 1
    on_card = capture is not False and device.type == "cuda"
    # the phases a graph may hold: none with a collective in them
    captured = (("rollout", "score", "update") if not multi
                else ("rollout", "score") if mp == 1 else ())
    if not on_card:
        captured = ()
    graphs = Graphs(device) if captured else None
    roll_graphs = graphs if "rollout" in captured else None
    obs_space = env.observation_space(env_params)
    obs_dim = flatdim(obs_space)
    head_dim = act_dim * n_bins if n_bins else act_dim
    act = None if n_bins else default_act_transform(
        env, env_params, space if pap else None)

    def shard():
        """The block in which this rank draws as its rows of the global
        batch (a no-op without dp)."""
        if dp == 1:
            return contextlib.nullcontext()
        return env_shard(offset, B, cfg.num_envs)

    def stored(obs):
        return obs.to(torch.bfloat16) if cfg.obs_bf16 else obs

    def prep(obs_raw):
        """The flat obs the policy sees, in their storage dtype: a view's
        (B, n_agents, D) as they are, a single-agent env's flattened."""
        if ma:
            return stored(obs_raw.float())
        return stored(flatten(obs_space, obs_raw, batch_dims=1))

    if fused:
        apply = policy_apply_bf16
        layout = env.fused_layout(env_params)
        D, u_lo = layout["obs_cols"], layout["u_lo"]
        if D != obs_dim:
            raise ValueError(f"learner block obs width {D} != obs dim "
                             f"{obs_dim}")

        def unroll(policy, generator, carry):
            out = env.fused_policy_unroll(env_params, policy, B, T,
                                          generator=generator)
            lrn = out["lrn"]                        # (T, B, D + n) bf16
            return {"obs": lrn[..., :D],
                    "u": lrn[..., u_lo:u_lo + act_dim].float(),
                    "reward": out["reward"], "done": out["done"]}
    else:
        apply = _apply_stacked_f32 if pap else _apply_f32
        if uma:
            # the base env's obs dicts, flattened: one row for each env
            base_space = env.base.observation_space(env_params.base)
            sample = _sampler(
                lambda o: stored(flatten(base_space, o, batch_dims=1)),
                apply, act, n_bins, agents=n_agents)
        else:
            sample = _sampler(prep, apply, act, n_bins)
    if path == "episodic":
        # the sampling policy of the last policy rolled out: a captured
        # episode writes the buffers of the sampler it was captured with,
        # and a new policy's episode (a new key) replaces that graph
        samplers = {}
        roll = env.uniform_ma_unroll if uma else env.batch_unroll
        share = device_const(float(n_agents), device)

        def unroll(policy, generator, carry):
            sampler = samplers.get(policy)
            if sampler is None:
                samplers.clear()
                sampler = samplers[policy] = _SamplingPolicy(sample, T)
            ts = roll(env_params, sampler, policy, B, T, generator,
                      graphs=roll_graphs)
            # uma: the base env's global reward, each agent's share
            reward = ts.reward / share if uma else ts.reward
            return {"obs": sampler.obs, "u": sampler.u,
                    "reward": reward, "done": ts.done}
    elif path == "generic":
        step = phased_autoreset_step(env)
        held = {}     # the rollout's buffers, made at its first call

        def buffers(carry):
            """The env state, obs, trajectory rows and row counter that
            both one-step graphs read and write in place."""
            if "bufs" not in held:
                obs = prep(carry["obs"])
                lead = tuple(obs.shape[:-1]) if ma else (B,)
                rows = {"obs": obs.new_empty((T,) + tuple(obs.shape)),
                        "u": torch.empty(
                            (T,) + lead + (act_dim,), device=device,
                            dtype=torch.long if n_bins else torch.float32),
                        "reward": torch.empty((T,) + lead, device=device),
                        "done": torch.empty((T, B), dtype=torch.bool,
                                            device=device)}
                held["bufs"] = {
                    "env": tree_map(torch.clone, {
                        "state": carry["env_states"], "obs": carry["obs"]}),
                    "rows": rows,
                    "counter": torch.zeros(1, dtype=torch.long,
                                           device=device)}
            bufs = held["bufs"]
            tree_assign_(bufs["env"], {"state": carry["env_states"],
                                       "obs": carry["obs"]})
            return bufs

        def generic_step(policy, generator, bufs, guard, reset):
            """One autoreset step of the envs in ``bufs``, its row written
            at the counter: the part of the generic rollout that a CUDA
            graph captures (one graph with the reset, one without)."""
            env_now = bufs["env"]
            obs, u, action = sample(policy, env_now["obs"], generator)
            state, ts = step(env_params, env_now["state"], action,
                             generator, reset, guard if ep_len else None)
            tree_assign_(env_now, {"state": state, "obs": ts.obs})
            i = bufs["counter"]
            for key, v in zip(bufs["rows"], (obs, u, ts.reward, ts.done)):
                row = bufs["rows"][key]
                row.index_copy_(0, i, v[None].to(row.dtype))
            i.add_(1)
            return ()

        def unroll(policy, generator, carry):
            if carry is None:
                raise ValueError("the generic rollout needs the carry")
            bufs = buffers(carry)
            guard = carry["reset_guard"]
            bufs["counter"].zero_()
            phase = int(carry["env_phase"])
            # restored after a capture's warm-up; the rows are not: the
            # replay after it rewrites the very row from the same inputs
            state = tree_leaves(bufs["env"]) + [bufs["counter"], guard]
            for reset in reset_schedule(ep_len, phase, T):
                fn = partial(generic_step, policy, generator, bufs, guard,
                             reset)
                if roll_graphs is None:
                    fn()
                else:
                    key = ("generic", reset, id(policy), id(generator),
                           id(bufs), id(guard))
                    roll_graphs(key, fn, generators=(generator,),
                                state=state, slot=("rollout", reset))
            carry["env_states"] = bufs["env"]["state"]
            carry["obs"] = bufs["env"]["obs"]
            if ep_len:
                carry["env_phase"].fill_((phase + T) % ep_len)
            out = dict(bufs["rows"])
            out["last_obs"] = prep(bufs["env"]["obs"])
            return out

    def logp_of(mu, log_std, u):
        if n_bins:
            return _categorical_logp(_logits(mu, n_bins), u)
        if uma:
            return _uma_logp(mu, log_std, u)
        return _gauss_logp(mu, log_std, u, mask)

    def init_state(generator: torch.Generator) -> dict:
        if graphs is not None:
            graphs.clear()          # the last carry's captures and pool
        if pap:
            policy = init_stacked_policy(n_agents, obs_dim, head_dim,
                                         cfg.hidden, generator, device)
        else:
            policy = init_policy(obs_dim, head_dim, cfg.hidden, generator,
                                 device)
        shard_policy(policy, mesh)
        carry = {"policy": policy, "opt": _adam(policy.parameters(), cfg,
                                                device)}
        if path == "generic":
            with shard():
                carry["env_states"], ts = env.reset(env_params, generator, B)
            carry["obs"] = ts.obs
            carry["env_phase"] = torch.zeros((), dtype=torch.long)
            carry["reset_guard"] = torch.zeros((), dtype=torch.long,
                                               device=device)
        return carry

    @torch.no_grad()
    def rollout(policy: ActorCritic, generator: torch.Generator,
                carry: dict | None = None) -> dict:
        with trace.span("ppo.rollout", device), shard():
            return unroll(policy, generator, carry)

    def score_body(policy, obs, u, reward, done, last_obs=None):
        mu, log_std, value = apply(policy, obs)
        logp = logp_of(mu, log_std, u)
        if done.ndim < reward.ndim:
            # agent-axis rewards: each agent's episode ends with its env's
            done = done.reshape(done.shape + (1,) * (reward.ndim - done.ndim)
                                ).expand(reward.shape)
        # whole episodes terminate on their last step: no bootstrap value;
        # the generic rollout bootstraps from its last obs
        last_value = (torch.zeros_like(value[0]) if last_obs is None
                      else apply(policy, last_obs)[2])
        advs, rets = gae(cfg, value, reward * cfg.reward_scale, done,
                         last_value)
        if uma or pap:
            # rows (t, env), each carrying its agents: uma's u and logp
            # (rows, n_agents) around one obs row; the stacked policies'
            # obs, u, logp, adv and ret with the whole agent axis
            n = logp.shape[0] * logp.shape[1]
            if uma:
                return {"obs": obs.reshape(n, obs_dim),
                        "u": u.reshape(n, n_agents),
                        "logp": logp.reshape(n, n_agents),
                        "adv": advs.reshape(n), "ret": rets.reshape(n)}
            return {"obs": obs.reshape(n, n_agents, obs_dim),
                    "u": u.reshape(n, n_agents, act_dim),
                    "logp": logp.reshape(n, n_agents),
                    "adv": advs.reshape(n, n_agents),
                    "ret": rets.reshape(n, n_agents)}
        # rows (t, env), or (t, env, agent) for a shared policy over a view
        n = logp.numel()
        return {"obs": obs.reshape(n, obs_dim), "u": u.reshape(n, act_dim),
                "logp": logp.reshape(n), "adv": advs.reshape(n),
                "ret": rets.reshape(n)}

    @torch.no_grad()
    def score(policy: ActorCritic, out: dict) -> dict:
        with trace.span("ppo.score", device):
            args = (out["obs"], out["u"], out["reward"], out["done"]) + (
                (out["last_obs"],) if "last_obs" in out else ())
            if graphs is None or "score" not in captured:
                return score_body(policy, *args)
            key = ("score", id(policy)) + tuple(
                (a.shape, a.dtype) for a in args)
            return graphs(key, partial(score_body, policy), *args,
                          slot="score")

    def minibatch_body(policy, opt, flat, mb_idx, counter, sums):
        """One minibatch update: the rows ``mb_idx[counter]``, then
        ``counter`` += 1 and the metrics added to ``sums``."""
        idx = mb_idx.index_select(0, counter)[0]
        batch = {key: v[idx] for key, v in flat.items()}
        loss, metrics = loss_fn(policy, batch, cfg, apply, n_bins, mask, uma)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(policy.parameters(), cfg.max_grad_norm)
        opt.step()
        with torch.no_grad():
            counter.add_(1)
            sums.add_(torch.stack([metrics[k].detach() for k in METRICS]))
        return sums

    # rows of the flat block: (t, env) with the agents inside a row (uma,
    # stacked policies), or (t, env, agent) for a shared policy over a view
    row_agents = n_agents if ma and not (uma or pap) else 1

    def dp_minibatch(policy, opt, flat, idx, mb, sums):
        """A dp rank's part of one global minibatch update: its ``idx``
        rows, the loss's terms over the global count ``mb``, the gradients
        and metrics all-reduced over dp before the clip."""
        batch = {key: v[idx] for key, v in flat.items()}
        loss, metrics = loss_fn(policy, batch, cfg, apply, n_bins, mask, uma,
                                red=DpReduce(mesh, mb))
        opt.zero_grad(set_to_none=False)
        loss.backward()
        params = list(policy.parameters())
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            stats = torch.stack([metrics[k].detach() for k in METRICS])
            buf = mesh.dp_sum_(torch.cat([p.grad.reshape(-1) for p in params]
                                         + [stats]))
            at = 0
            for p in params:
                p.grad.copy_(buf[at:at + p.numel()].view_as(p))
                at += p.numel()
            sums.add_(buf[at:])
        clip_by_global_norm(params, cfg.max_grad_norm, mesh,
                            mp_param_axes(policy))
        opt.step()

    def update(policy: ActorCritic, opt, flat: dict,
               generator: torch.Generator) -> dict:
        with trace.span("ppo.update", device):
            return update_body(policy, opt, flat, generator)

    def update_body(policy, opt, flat, generator):
        n = flat["logp"].shape[0] * dp      # the global batch's rows
        mb = n // cfg.minibatches
        dropped = n - mb * cfg.minibatches
        if mb == 0:
            raise ValueError(
                f"PPO minibatching would drop ALL {n} samples per epoch: "
                f"rollout_len*num_envs[*n_agents]={n} yields fewer than "
                f"minibatches={cfg.minibatches} rows. Lower minibatches or "
                f"raise num_envs/rollout_len.")
        if dropped:
            warnings.warn(
                f"PPO minibatching drops {dropped}/{n} samples per epoch "
                f"(rollout_len*num_envs[*n_agents]={n} not divisible by "
                f"minibatches={cfg.minibatches})", stacklevel=3)
        count = cfg.epochs * cfg.minibatches
        with trace.span("ppo.update.perms"):
            # every epoch's permutation first, in the order the epochs use
            # them
            perms = [torch.randperm(n, generator=generator,
                                    device=generator.device).to(device)
                     for _ in range(cfg.epochs)]
            mb_idx = torch.stack([p[:cfg.minibatches * mb] for p in perms]
                                 ).reshape(count, mb)
        sums = torch.zeros(len(METRICS), device=device)
        if multi:
            # this rank's rows of each global minibatch, in its order (all
            # of them at dp = 1)
            per_t = cfg.num_envs * row_agents
            e = mb_idx // row_agents % cfg.num_envs
            own = (e >= offset) & (e < offset + B)
            local = (mb_idx // per_t * (B * row_agents)
                     + (e - offset) * row_agents + mb_idx % row_agents)
            trace.count("host_syncs.dp_rows")
            for idx in torch.split(local[own], own.sum(1).tolist()):
                dp_minibatch(policy, opt, flat, idx, mb, sums)
            return dict(zip(METRICS, sums))
        counter = torch.zeros(1, dtype=torch.long, device=device)
        body = partial(minibatch_body, policy, opt)
        if graphs is None or "update" not in captured:
            for _ in range(count):
                body(flat, mb_idx, counter, sums)
        else:
            state = list(policy.parameters()) + _adam_state(opt)
            key = ("update", id(opt), n, mb) + tuple(map(id, state))
            sums = graphs(key, body, flat, mb_idx, counter, sums,
                          state=state, repeat=count, slot="update")
        return dict(zip(METRICS, sums))

    guard = ScheduleGuard(env, ep_len) if path == "generic" else None

    def train_step(carry: dict, generator: torch.Generator):
        with trace.span("ppo.step", device):
            policy, opt = carry["policy"], carry["opt"]
            out = rollout(policy, generator, carry)
            # read before the later phases' graphs run: a graph captured
            # after them may hold its outputs in their scratch memory
            metrics = {"mean_reward": out["reward"].mean(),
                       "episode_done_frac": out["done"].float().mean()}
            sums = update(policy, opt, score(policy, out), generator)
            count = cfg.epochs * cfg.minibatches
            metrics.update({key: v / count for key, v in sums.items()})
            if multi:
                # every rank reports the global metrics
                keys = list(metrics)
                local = torch.stack([metrics[k] for k in keys])
                local[:2] = mesh.dp_sum_(local[:2].clone()) / dp
                metrics = dict(zip(keys, local))
            if guard is not None:
                guard.push(carry["reset_guard"])
        return carry, metrics

    def check(carry: dict) -> None:
        """Reads the reset guard of the newest train step now."""
        if guard is not None:
            guard.check()

    train_step.rollout, train_step.score = rollout, score
    train_step.update, train_step.graphs = update, graphs
    train_step.captured, train_step.check = captured, check
    train_step.path, train_step.rollout_len = path, T
    train_step.uma, train_step.per_agent = uma, pap
    train_step.n_agents, train_step.mesh = n_agents, mesh

    @torch.no_grad()
    def actor(policy: ActorCritic, obs_raw) -> torch.Tensor:
        """The deterministic actions of the raw batched obs (a view's, on
        the uniform-obs path too): the squashed mean, or each dimension's
        most likely bin (the evaluation policy)."""
        mu = apply(policy, prep(obs_raw))[0]
        if n_bins:
            return torch.argmax(_logits(mu, n_bins), -1)
        return act(mu)

    # the evaluation hooks every learner shares (train.make_evaluator)
    train_step.actor = train_step.actor_fn = actor
    train_step.actor_key = "policy"
    return init_state, train_step
