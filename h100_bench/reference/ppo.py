"""Plain reference of the PPO learner: the actor-critic MLP, the rollout's
scoring, GAE and the clipped-PPO epochs with a global-norm clip and Adam,
in float32 PyTorch with the configuration's rounding points written out.

The actor-critic is trunk1 (obs -> H), trunk2 (H -> H), both tanh, and two
heads, mu (H -> act) and value (H -> 1), with a state-free log_std. Its
operands are rounded to ``prec`` ("bf16" as configured, "fp8" for the
control) where the configuration rounds them: the obs, the weights and
each hidden activation, products accumulated in float32; the gradients
that flow back through those roundings are rounded the same way.

:func:`follow` runs the train steps that the benchmark drove the program
through, from the same initial weights, with the env reference's rollout
replayed from the benchmark generator's saved state and the minibatch
permutations drawn from that generator after the rollout's draws, as the
program draws them.
"""
from __future__ import annotations

import math

import torch

from .ev import round_to

def init_weights(obs_dim: int, act_dim: int, hidden: int, seed: int,
                 device) -> dict:
    """He-normal weights N(0, 2 / fan_in) drawn from ``seed`` on the device
    in one call, zero biases, log_std -0.5: {leaf: tensor} in the torch
    ``Linear`` (out, in) orientation."""
    shapes = {"trunk1": (hidden, obs_dim), "trunk2": (hidden, hidden),
              "mu": (act_dim, hidden), "value": (1, hidden)}
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    draw = torch.randn(sum(a * b for a, b in shapes.values()), generator=g,
                       device=device)
    w, at = {}, 0
    for name, (dout, din) in shapes.items():
        w[f"{name}.weight"] = (draw[at:at + dout * din].view(dout, din)
                               * math.sqrt(2.0 / din))
        w[f"{name}.bias"] = torch.zeros(dout, device=device)
        at += dout * din
    w["log_std"] = torch.full((act_dim,), -0.5, device=device)
    return w


def forward(w: dict, obs: torch.Tensor, prec: str):
    """(mu, value) of obs (rows, obs_dim) already rounded to ``prec``."""
    def r(x):
        return round_to(x, prec)

    h = torch.tanh(obs @ r(w["trunk1.weight"]).t() + w["trunk1.bias"])
    h = r(torch.tanh(r(h) @ r(w["trunk2.weight"]).t() + w["trunk2.bias"]))
    mu = h @ r(w["mu.weight"]).t() + w["mu.bias"]
    value = (h @ r(w["value.weight"]).t() + w["value.bias"])[..., 0]
    return mu, value


def gauss_logp(mu, log_std, u):
    return torch.sum(-0.5 * ((u - mu) ** 2 / torch.exp(2 * log_std)
                             + 2 * log_std + math.log(2 * math.pi)), -1)


def gae(value, reward, done, gamma: float, lam: float):
    """Advantages and returns over (T, B), no bootstrap after the last
    step."""
    adv = torch.empty_like(value)
    nxt = torch.zeros_like(value[0])
    v_next = torch.zeros_like(value[0])
    for t in range(value.shape[0] - 1, -1, -1):
        keep = 1.0 - done[t].float()
        delta = reward[t] + gamma * v_next * keep - value[t]
        nxt = delta + gamma * lam * keep * nxt
        adv[t] = nxt
        v_next = value[t]
    return adv, adv + value


class Adam:
    """Adam (beta1 0.9, beta2 0.999, eps 1e-8) on a dict of leaves."""

    def __init__(self, w: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in w.items()}
        self.v = {k: torch.zeros_like(v) for k, v in w.items()}

    @torch.no_grad()
    def step(self, w: dict, grads: dict):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(1e-8)
            w[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def follow(env_ref, hp: dict, w0: dict, gen_states: list, prec: str = "bf16",
           env_prec: str = "f32", fault: str | None = None) -> dict:
    """The train steps the program ran from ``w0``, one for each saved
    generator state: each step's rollout (u rounded to the storage
    precision, rewards), its mean losses, Adam's first moment after the
    first step and each leaf's change over all of them. ``hp``: num_envs,
    epochs, minibatches, lr, gamma, lam, clip_eps, vf_coef, max_grad_norm,
    reward_scale. ``fault`` plants one of the faults the check must catch
    ("half_batch": each minibatch's loss over its first half only;
    "altered_reward": one reward of the first step changed)."""
    B = hp["num_envs"]
    w = {k: v.detach().clone().float() for k, v in w0.items()}
    opt = Adam(w, hp["lr"])
    out = {"u": [], "reward": [], "loss": [], "count": []}

    def actor(obs):
        ob = round_to(obs, prec)
        mu, _ = forward(w, ob, prec)
        return ob, mu, torch.exp(w["log_std"])

    for k, state in enumerate(gen_states):
        days, seed, g = env_ref.episode_draws(state, B)
        count = torch.zeros((), dtype=torch.long, device=days.device)
        with torch.no_grad():
            obs, u, roll = env_ref.policy_episode(actor, days, seed, env_prec,
                                                  count)
        u = round_to(u, prec)
        reward = roll[..., 0]
        if fault == "altered_reward" and k == 0:
            reward = reward.clone()
            reward[100, 0] += 1.0
        out["u"].append(u)
        out["reward"].append(reward)
        out["count"].append(count)
        T = reward.shape[0]
        done = torch.zeros((T, B), dtype=torch.bool, device=reward.device)
        done[-1] = True
        with torch.no_grad():
            mu, value = forward(w, obs, prec)
            logp = gauss_logp(mu, w["log_std"], u)
            adv, ret = gae(value, reward * hp["reward_scale"], done,
                           hp["gamma"], hp["lam"])
        n = T * B
        flat = {"obs": obs.reshape(n, -1), "u": u.reshape(n, -1),
                "logp": logp.reshape(n), "adv": adv.reshape(n),
                "ret": ret.reshape(n)}
        del obs, mu, value, logp, adv, ret
        mb = n // hp["minibatches"]
        perms = [torch.randperm(n, generator=g, device=g.device)
                 for _ in range(hp["epochs"])]
        idx = torch.stack([p[:hp["minibatches"] * mb] for p in perms]
                          ).reshape(-1, mb)
        sums = torch.zeros(3, device=reward.device)
        for rows in idx:
            if fault == "half_batch":
                rows = rows[:mb // 2]
            sums += update(w, opt, {key: v[rows] for key, v in flat.items()},
                           hp, prec)
        out["loss"].append((sums / idx.shape[0]).tolist())
        if k == 0:
            out["m1"] = {key: v.clone() for key, v in opt.m.items()}
    out["delta"] = {key: w[key] - w0[key].float() for key in w}
    return out


def update(w: dict, opt: Adam, batch: dict, hp: dict, prec: str):
    """One clipped-PPO minibatch update; returns (pg, vf, entropy)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    mu, value = forward(leaves, batch["obs"], prec)
    log_std = leaves["log_std"]
    logp = gauss_logp(mu, log_std, batch["u"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - batch["logp"])
    eps = hp["clip_eps"]
    pg = -torch.mean(torch.minimum(ratio * adv,
                                   torch.clamp(ratio, 1 - eps, 1 + eps) * adv))
    vf = 0.5 * torch.mean((value - batch["ret"]) ** 2)
    ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    loss = pg + hp["vf_coef"] * vf
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        cap = hp["max_grad_norm"]
        grads = {k: torch.where(norm < cap, g, g / norm * cap)
                 for k, g in grads.items()}
    opt.step(w, grads)
    return torch.stack([pg.detach(), vf.detach(), ent.detach()])
