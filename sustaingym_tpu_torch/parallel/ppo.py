"""PPO learner: the episodic paths of ``sustaingym_tpu.parallel.ppo``.

One train step = one rollout of whole episodes, a re-scoring of (logp,
value) in one batched pass, GAE on ``reward * reward_scale``, and
clipped-PPO epochs over ``torch.randperm`` minibatches of all T x B
samples. The rollout goes one of two ways, as in the JAX package:

- **fused** (EVChargingEnv or BuildingEnv with ``obs_bf16``, in a
  configuration its kernel computes): the actor runs inside the env's
  policy-in-kernel rollout (``fused_policy_unroll``); the rollout and the
  learner score the SAME bf16 obs with the same bf16 operands
  (:func:`policy_apply_bf16`);
- **episodic** (otherwise, an env with a lockstep ``batch_unroll``:
  BuildingEnv, CogenEnv, DataCenterEnv, ElectricityMarketEnv): the
  sampling policy applies the f32 :func:`policy_apply` to the flat obs,
  draws a Gaussian ``u`` from the generator and squashes it into the Box
  action space; the obs it saw (bf16 if ``obs_bf16``) and ``u`` are
  recorded and re-scored afterwards.

Either way, with lr=0 every ratio is exactly 1 (the exact-ratio invariant
of the JAX package's tests).

Not ported yet: the generic (non-episodic) rollout, A2C, the multi-agent
and per-agent paths, categorical heads and sharding.
"""
from __future__ import annotations

import math
import warnings

import torch
from torch import nn

from ..core import Discrete, MultiDiscrete, dataclass, flatdim, flatten

__all__ = ["PPOConfig", "ActorCritic", "init_policy", "policy_apply",
           "policy_apply_bf16", "default_act_transform", "gae", "loss_fn",
           "clip_by_global_norm", "make_train_step"]


@dataclass
class PPOConfig:
    """Each rollout is one whole episode per env (the env's
    ``episode_steps``)."""
    num_envs: int = 256
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


class ActorCritic(nn.Module):
    """Diag-Gaussian tanh MLP actor-critic over flat observations (the
    JAX package's trunk1/trunk2/mu/value/log_std policy tree)."""

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


def policy_apply(policy: ActorCritic, obs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """obs (..., obs_dim) f32 -> (mu, log_std, value), all f32."""
    h = torch.tanh(obs @ policy.trunk1.weight.t() + policy.trunk1.bias)
    h = torch.tanh(h @ policy.trunk2.weight.t() + policy.trunk2.bias)
    mu = h @ policy.mu.weight.t() + policy.mu.bias
    value = (h @ policy.value.weight.t() + policy.value.bias)[..., 0]
    return mu, policy.log_std, value


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def policy_apply_bf16(policy: ActorCritic, obs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu, log_std, value) from bf16 obs with bf16 weights and hidden
    activations and f32 accumulation — the kernel actor's numerics, used
    for both the rollout's scoring and every update. The f32 matmuls of
    bf16-valued operands need full f32 precision (no TF32)."""
    h = torch.tanh(obs.float() @ _bf(policy.trunk1.weight).t()
                   + policy.trunk1.bias)
    h = torch.tanh(_bf(h) @ _bf(policy.trunk2.weight).t()
                   + policy.trunk2.bias)
    h = _bf(h)
    mu = h @ _bf(policy.mu.weight).t() + policy.mu.bias
    value = (h @ _bf(policy.value.weight).t() + policy.value.bias)[..., 0]
    return mu, policy.log_std, value


def _gauss_logp(mu, log_std, a):
    """Diagonal-Gaussian log-prob, summed over the last axis."""
    var = torch.exp(2 * log_std)
    terms = -0.5 * ((a - mu) ** 2 / var + 2 * log_std
                    + math.log(2 * math.pi))
    return torch.sum(terms, -1)


def default_act_transform(env, params):
    """Maps the policy's unbounded output to the env's Box action space by
    tanh squashing (the kernel bakes in Box(0, 1))."""
    space = env.action_space(params)
    low = torch.as_tensor(space.low, dtype=torch.float32)
    high = torch.as_tensor(space.high, dtype=torch.float32)

    def fn(u):
        lo, hi = low.to(u.device), high.to(u.device)
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


def loss_fn(policy: ActorCritic, batch: dict, cfg: PPOConfig,
            apply=policy_apply_bf16):
    """Clipped-PPO loss on one minibatch, scored by ``apply`` (the same
    function that scored the rollout); returns (loss, {pg_loss, vf_loss,
    entropy})."""
    mu, log_std, value = apply(policy, batch["obs"])
    logp = _gauss_logp(mu, log_std, batch["u"])
    adv = batch["adv"]
    # population std, as jnp.std
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - batch["logp"])
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
    vf = 0.5 * torch.mean((value - batch["ret"]) ** 2)
    ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: g <- g / norm * max_norm where
    norm >= max_norm (no epsilon, unlike ``clip_grad_norm_``). Returns the
    norm; never synchronises with the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def make_train_step(env, env_params, cfg: PPOConfig):
    """Builds (init_state, train_step).

    ``init_state(generator) -> carry`` with the policy and its Adam state;
    ``train_step(carry, generator) -> (carry, metrics)`` runs one rollout +
    update in place on the params' device and returns 0-d metric tensors
    (no host synchronisation). Its three phases are also attributes of
    ``train_step``, for timing them apart: ``rollout(policy, generator) ->
    out``, ``score(policy, out) -> samples`` (re-scoring and GAE) and
    ``update(policy, opt, samples, generator) -> summed metrics``.

    The rollout is the fused path when ``cfg.obs_bf16``, the env has a
    ``fused_policy_unroll`` and ``env.fused_policy_unroll_supported(params,
    num_envs)``; else the episodic path when the env has a lockstep
    ``batch_unroll`` (module docstring); anything else raises."""
    has_fused = hasattr(env, "fused_policy_unroll")
    fused = (cfg.obs_bf16 and has_fused and env.fused_policy_unroll_supported(
        env_params, cfg.num_envs))
    if not fused and not hasattr(env, "batch_unroll"):
        if has_fused:
            raise ValueError(
                f"{type(env).__name__} with float32 obs needs its lockstep "
                f"batch_unroll, which is not ported yet (ROADMAP Queue 1, "
                f"'EV lockstep rollouts'); set obs_bf16 for the fused "
                f"policy-in-kernel path")
        raise ValueError(
            "PPO in the port needs an env with a lockstep batch_unroll "
            "(episodic path) or a fused_policy_unroll (fused path, obs_bf16); "
            "the generic rollout is not ported yet (ROADMAP Queue 1, 'EV "
            "lockstep rollouts')")
    if isinstance(env.action_space(env_params), (Discrete, MultiDiscrete)):
        raise ValueError(
            f"{type(env).__name__} has a discrete action space (the market's "
            f"discrete=True, the building's is_continuous_action=False), "
            f"which needs the categorical PPO head; it is not ported yet "
            f"(ROADMAP Queue 1, 'categorical PPO head')")
    device = env_params.device
    ep_len = env.episode_steps(env_params)
    obs_space = env.observation_space(env_params)
    obs_dim = flatdim(obs_space)
    act_dim = flatdim(env.action_space(env_params))
    if fused:
        apply = policy_apply_bf16
        layout = env.fused_layout(env_params)
        D, u_lo = layout["obs_cols"], layout["u_lo"]
        if D != obs_dim:
            raise ValueError(f"learner block obs width {D} != obs dim "
                             f"{obs_dim}")

        def unroll(policy, generator):
            out = env.fused_policy_unroll(env_params, policy, cfg.num_envs,
                                          ep_len, generator=generator)
            lrn = out["lrn"]                        # (T, B, D + n) bf16
            return {"obs": lrn[..., :D],
                    "u": lrn[..., u_lo:u_lo + act_dim].float(),
                    "reward": out["reward"], "done": out["done"]}
    else:
        apply = _apply_f32
        act = default_act_transform(env, env_params)

        def unroll(policy, generator):
            seen, drawn = [], []

            def sampling_policy(p, obs_raw, gen):
                obs = flatten(obs_space, obs_raw, batch_dims=1)
                if cfg.obs_bf16:
                    obs = obs.to(torch.bfloat16)
                mu, log_std, _ = apply(p, obs)
                u = mu + torch.exp(log_std) * torch.randn(
                    mu.shape, generator=gen, device=gen.device)
                seen.append(obs)
                drawn.append(u)
                return act(u)

            ts = env.batch_unroll(env_params, sampling_policy, policy,
                                  cfg.num_envs, ep_len, generator)
            return {"obs": torch.stack(seen), "u": torch.stack(drawn),
                    "reward": ts.reward, "done": ts.done}

    def init_state(generator: torch.Generator) -> dict:
        policy = init_policy(obs_dim, act_dim, cfg.hidden, generator, device)
        opt = torch.optim.Adam(policy.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return {"policy": policy, "opt": opt}

    @torch.no_grad()
    def rollout(policy: ActorCritic, generator: torch.Generator) -> dict:
        return unroll(policy, generator)

    @torch.no_grad()
    def score(policy: ActorCritic, out: dict) -> dict:
        obs, u = out["obs"], out["u"]
        mu, log_std, value = apply(policy, obs)
        logp = _gauss_logp(mu, log_std, u)
        # episodes terminate on the last step: no bootstrap value
        advs, rets = gae(cfg, value, out["reward"] * cfg.reward_scale,
                         out["done"], torch.zeros_like(value[0]))
        n = logp.numel()
        return {"obs": obs.reshape(n, obs_dim), "u": u.reshape(n, act_dim),
                "logp": logp.reshape(n), "adv": advs.reshape(n),
                "ret": rets.reshape(n)}

    def update(policy: ActorCritic, opt, flat: dict,
               generator: torch.Generator) -> dict:
        n = flat["logp"].shape[0]
        mb = n // cfg.minibatches
        if mb == 0:
            raise ValueError(f"PPO minibatching needs at least "
                             f"{cfg.minibatches} samples, got {n}")
        if n % cfg.minibatches:
            warnings.warn(f"PPO minibatching drops {n - mb * cfg.minibatches}"
                          f"/{n} samples per epoch", stacklevel=2)
        sums = {}
        for _ in range(cfg.epochs):
            perm = torch.randperm(n, generator=generator,
                                  device=generator.device).to(device)
            for k in range(cfg.minibatches):
                idx = perm[k * mb:(k + 1) * mb]
                batch = {key: v[idx] for key, v in flat.items()}
                loss, metrics = loss_fn(policy, batch, cfg, apply)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm(policy.parameters(), cfg.max_grad_norm)
                opt.step()
                for key, v in metrics.items():
                    sums[key] = sums.get(key, 0.0) + v.detach()
        return sums

    def train_step(carry: dict, generator: torch.Generator):
        policy, opt = carry["policy"], carry["opt"]
        out = rollout(policy, generator)
        sums = update(policy, opt, score(policy, out), generator)
        count = cfg.epochs * cfg.minibatches
        metrics = {"mean_reward": out["reward"].mean(),
                   "episode_done_frac": out["done"].float().mean(),
                   **{key: v / count for key, v in sums.items()}}
        return carry, metrics

    train_step.rollout, train_step.score = rollout, score
    train_step.update = update
    return init_state, train_step
