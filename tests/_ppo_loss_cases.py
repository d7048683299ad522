"""Inputs of the PPO loss head's tests (``test_torch_ppo_loss.py`` on the
CPU, ``test_torch_gpu_kernels.py`` on the card) and their float64
reference: autograd through ``parallel.ppo.loss_fn``'s own chain.

A case names where the ratios sit against the clip range [1 - eps,
1 + eps] (eps = 0.2):

- ``inside``: ratios drawn in (0.85, 1.15);
- ``beyond``: ratios 0.5, 0.6, 1.4 and 1.7, with both signs of the
  advantage;
- ``at_bounds``: every ratio exactly at a bound (``u = mu`` and log_std
  -0.5 log(2 pi), so the log-prob is ~0). With ``exact=True`` (float64 on
  the CPU, where the plain version computes the very log-prob that
  ``loss_fn`` does) ``logp_old`` is moved an ulp at a time until
  ``exp(logp - logp_old)`` is the bound itself, and the rows take all four
  (bound, advantage sign) pairs. In float32 (``exact=False``) log_std is
  -0.5 log(2 pi) as float32 rounds it, so each term of the log-prob is 0
  exactly, and ``-logp_old`` is the float32 whose exponential lies nearest
  the float32 bound (a few hundredths of an ulp from it), so any faithful
  expf rounds it to the bound. Float64 then puts each ratio a rounding off
  the bound, so the rows take only the two pairs where the gradient is
  continuous there (lower with a positive advantage, upper with a negative
  one): at the other two it jumps from all to nothing;
- ``const_adv``: every advantage 0.375, so the normalised advantages are
  exactly 0 (std 0).
"""
from __future__ import annotations

import math

import torch

from sustaingym_tpu_torch.parallel import PPOConfig, ppo

CASES = ("inside", "beyond", "at_bounds", "const_adv")
CLIP_EPS = 0.2


def make_case(case: str, rows: int, act_dim: int, ent_coef: float,
              strided: bool, dtype=torch.float64, exact: bool = True,
              seed: int = 0) -> dict:
    """The head outputs and the minibatch of one case, on the CPU: ``mu``
    a slice of a (rows, act_dim + 1) head product when ``strided``, whose
    last column is ``value``."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    head = torch.randn((rows, act_dim + 1), generator=g, dtype=f64)
    log_std = -torch.rand((act_dim,), generator=g, dtype=f64)
    u = head[:, :act_dim] + torch.exp(log_std) * torch.randn(
        (rows, act_dim), generator=g, dtype=f64)
    adv = torch.randn((rows,), generator=g, dtype=f64)
    ret = torch.randn((rows,), generator=g, dtype=f64)
    lo, hi = 1 - CLIP_EPS, 1 + CLIP_EPS
    if case == "inside" or case == "const_adv":
        target = 0.85 + 0.3 * torch.rand((rows,), generator=g, dtype=f64)
    elif case == "beyond":
        target = torch.tensor([0.5, 0.6, 1.4, 1.7], dtype=f64).repeat(
            rows // 4 + 1)[:rows]
        # both signs of the advantage beside each ratio
        adv = adv.abs() * torch.tensor([1.0, -1.0, -1.0, 1.0, 1.0, 1.0,
                                        -1.0, -1.0],
                                       dtype=f64).repeat(rows // 8 + 1)[:rows]
    elif case == "at_bounds":
        log_std = torch.full((act_dim,), -0.5 * math.log(2 * math.pi),
                             dtype=f64)
        if not exact:
            # half of float32's log(2 pi): 2 log_std + log(2 pi) is 0 in
            # float32
            log_std = torch.full_like(log_std, -0.5 * float(
                torch.tensor(math.log(2 * math.pi), dtype=torch.float32)))
        u = head[:, :act_dim].clone()
        pairs = ([(lo, 1.0), (lo, -1.0), (hi, 1.0), (hi, -1.0)] if exact
                 else [(lo, 1.0), (hi, -1.0)])
        target = torch.tensor([b for b, _ in pairs], dtype=f64).repeat(
            rows // len(pairs) + 1)[:rows]
        sign = torch.tensor([s for _, s in pairs], dtype=f64).repeat(
            rows // len(pairs) + 1)[:rows]
        adv = (adv.abs() + 0.1) * sign
    else:
        raise ValueError(case)
    if case == "const_adv":
        adv = torch.full((rows,), 0.375, dtype=f64)
    elif case != "beyond":
        # centred, so each advantage keeps its sign once normalised
        adv = adv - adv.mean()
    # the casts first: the ratios are placed for the values the head sees
    head, log_std, u, adv, ret = (x.to(dtype) for x in
                                  (head, log_std, u, adv, ret))
    c = {"head": head, "strided": strided, "log_std": log_std, "u": u,
         "adv": adv, "ret": ret, "clip_eps": CLIP_EPS, "vf_coef": 0.5,
         "ent_coef": ent_coef}
    mu = head[:, :act_dim] if strided else head[:, :act_dim].contiguous()
    logp = ppo._gauss_logp(mu.double(), log_std.double(), u.double())
    logp_old = logp - torch.log(target)
    if case == "at_bounds" and not exact:
        # the float32 x nearest to log(bound) in exp: logp is 0 in float32
        b = target.to(dtype).double()
        x = torch.log(b).to(dtype)
        cands = [x]
        for step in (math.inf, -math.inf):
            y = x
            for _ in range(16):
                y = torch.nextafter(y, torch.full_like(y, step))
                cands.append(y)
        cands = torch.stack(cands)
        best = (torch.exp(cands.double()) - b).abs().argmin(0)
        logp_old = -cands.gather(0, best[None])[0].double()
    if case == "at_bounds" and exact:
        for _ in range(200):
            r = torch.exp(logp - logp_old)
            if bool((r == target).all()):
                break
            step = torch.where(r < target, -math.inf, math.inf).to(f64)
            logp_old = torch.where(r == target, logp_old,
                                   torch.nextafter(logp_old, step))
        assert bool((torch.exp(logp - logp_old) == target).all())
    c["logp_old"] = logp_old.to(dtype)
    return c


def args_of(c: dict, device=None) -> tuple:
    """The case's arguments of ``ppo_gauss_loss`` on ``device``: ``mu``
    and ``value`` slices of the head product there (``mu`` strided when
    the case is), then log_std, u, logp_old, adv, ret and the three
    coefficients."""
    head = c["head"].to(device)
    A = head.shape[1] - 1
    mu = head[:, :A] if c["strided"] else head[:, :A].contiguous()
    return (mu, c["log_std"].to(device), head[:, A]) + tuple(
        c[k].to(device) if isinstance(c[k], torch.Tensor) else c[k]
        for k in ("u", "logp_old", "adv", "ret", "clip_eps", "vf_coef",
                  "ent_coef"))


def reference(c: dict) -> tuple[dict, dict]:
    """Autograd through ``loss_fn`` in float64 on the CPU: loss, pg, vf,
    ent, d_mu, d_value, d_log_std, and each output's scale (the largest
    absolute entry of a gradient; for pg, vf and the loss the mean of the
    absolute per-row terms; for ent the sum of its absolute terms).

    A float32 case's log-prob takes log(2 pi) as float32 rounds it, as the
    float32 computations under test and the scoring they divide by do: its
    A halves move the row's log-prob by ~1.6e-8 A, so the reference shifts
    ``logp_old`` by the same amount and measures the arithmetic alone."""
    head = c["head"].double().clone().requires_grad_(True)
    log_std = c["log_std"].double().clone().requires_grad_(True)
    A = head.shape[1] - 1
    mu, value = head[:, :A], head[:, A]
    logp_old = c["logp_old"].double()
    if c["head"].dtype == torch.float32:
        log_2pi = math.log(2 * math.pi)
        log_2pi_f32 = float(torch.tensor(log_2pi, dtype=torch.float32))
        logp_old = logp_old + 0.5 * A * (log_2pi_f32 - log_2pi)
    batch = {"obs": None, "u": c["u"].double(),
             "logp": logp_old, "adv": c["adv"].double(),
             "ret": c["ret"].double()}
    cfg = PPOConfig(clip_eps=c["clip_eps"], vf_coef=c["vf_coef"],
                    ent_coef=c["ent_coef"])
    loss, m = ppo.loss_fn(None, batch, cfg,
                          apply=lambda policy, obs: (mu, log_std, value))
    loss.backward()
    out = {"loss": loss.detach(), "pg": m["pg_loss"].detach(),
           "vf": m["vf_loss"].detach(), "ent": m["entropy"].detach(),
           "d_mu": head.grad[:, :A], "d_value": head.grad[:, A],
           "d_log_std": log_std.grad}
    with torch.no_grad():
        adv = batch["adv"]
        a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        ratio = torch.exp(ppo._gauss_logp(mu, log_std, batch["u"])
                          - batch["logp"])
        eps = c["clip_eps"]
        pg_terms = torch.minimum(ratio * a,
                                 torch.clamp(ratio, 1 - eps, 1 + eps) * a)
        vf_terms = 0.5 * (value - batch["ret"]) ** 2
        ent_terms = log_std + 0.5 * math.log(2 * math.pi * math.e)
        pg_s = pg_terms.abs().mean()
        vf_s = vf_terms.mean()
        ent_s = ent_terms.abs().sum()
        scale = {"pg": pg_s, "vf": vf_s, "ent": ent_s,
                 "loss": pg_s + c["vf_coef"] * vf_s + c["ent_coef"] * ent_s}
        for k in ("d_mu", "d_value", "d_log_std"):
            scale[k] = out[k].abs().max()
    return out, {k: float(v) for k, v in scale.items()}


NAMES = ("loss", "pg", "vf", "ent", "d_mu", "d_value", "d_log_std")


def gaps(got: tuple, want: dict, scale: dict) -> dict:
    """{output: largest absolute gap over its scale (0 where both are
    0)}."""
    out = {}
    for name, x in zip(NAMES, got):
        gap = float((x.detach().cpu().double() - want[name]).abs().max())
        out[name] = gap / scale[name] if scale[name] else (
            0.0 if gap == 0 else math.inf)
    return out
