"""Whole EV-charging episode segments: the two hand-written Hopper kernels
of ``csrc/ev_rollout.cu``, their host packing, and a plain PyTorch version
of each.

``ev_segment`` replaces ``sustaingym_tpu/ops/pallas/ev_rollout.py::
fused_ev_segment`` (the simulation tier), with both of its projection
operators: dual FISTA and ADMM, taken from the type of ``params.proj``.
``ev_policy_segment`` replaces ``::fused_ev_policy_segment`` (PPO rollouts
with the actor in the kernel), which computes dual FISTA only, as the TPU
kernel does.
What bounds each kernel and how it is laid out is in the ``.cu`` file.

The kernels read an ``EVParams``' tensors as they are: the (n_days, 289,
3n + 39) step table indexed by (day, t), the interleaved cone operator C
and the per-cone/per-station constants, so only the actor's weights need
packing (``pack_policy_weights``: bf16 (din, dout) for the plain versions
and a copy in the tensor cores' B-fragment order for the kernels).

Dispatch goes by device: CUDA params always run the kernel (a build or
launch failure raises), CPU params run the plain version
(``ev_segment_ref`` / ``ev_policy_segment_ref``). The plain versions are
the oracle for the kernels; they compute the same step with the shared
``envs.evcharging.env.advance`` and cast to bf16 at the kernel's points.

Each wrapper counts its kernel launches in its ``launches`` attribute.
Under a ``core.trace`` recording it closes its caller's ``ev.prelaunch``
span where it launches, and the range check's two host reads of the reset
days count as ``host_syncs.ev_days_min`` and ``host_syncs.ev_days_max``.

Random draws: the kernels use a Philox4x32-10 stream keyed by ``seed``;
the plain versions draw from a ``torch.Generator`` seeded with ``seed``.
Both are U[0, 1) actions / standard normals, but not the same numbers.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import dataclass, trace
from ...core.graph import count_launches
from ...envs.evcharging.env import EVParams, EVState, MAX_TIMESTEP, advance
from ...ops.qp import SOCProjection
from .wrap import (F, I, P, PI, U64, bind, check, ctas_per_sm, env_normals,
                   on_card, pad16, ptr, raise_on, seeded)

__all__ = ["PolicyWeights", "b_fragments", "pack_policy_weights",
           "check_policy_weights", "policy_weight_args", "ev_fused_layout",
           "ev_segment", "ev_segment_ref", "ev_policy_segment",
           "ev_policy_segment_ref", "ev_policy_occupancy",
           "ev_segment_occupancy"]

_MAX_STATIONS = 64
_MAX_CONE_ROWS = 32


@dataclass
class PolicyWeights:
    """Actor weights in the kernels' operand layouts: dense weights are
    (din, dout) bf16 (``w*``, the plain versions' operands) and the same in
    B-fragment order (``w*f``, see :func:`b_fragments`); biases and sigma =
    exp(log_std) f32."""
    w1: torch.Tensor   # (D, H)
    b1: torch.Tensor   # (H,)
    w2: torch.Tensor   # (H, H)
    b2: torch.Tensor   # (H,)
    wm: torch.Tensor   # (H, n)
    bm: torch.Tensor   # (n,)
    sigma: torch.Tensor  # (n,)
    w1f: torch.Tensor  # b_fragments(w1)
    w2f: torch.Tensor  # b_fragments(w2)
    wmf: torch.Tensor  # b_fragments(wm)


def b_fragments(w: torch.Tensor) -> torch.Tensor:
    """A (din, dout) bf16 weight in the order ``csrc/actor.cuh`` reads it as
    mma.m16n8k16 B fragments, zero-padded to multiples of 16: (dout / 16,
    din / 16, 32, 8), where for column pair p, k16 step kc and lane 4g + t
    the eight values are rows 16 kc + 2t + (0, 1, 8, 9) of column 16 p + g,
    then the same rows of column 16 p + 8 + g: one 16-byte load gives a lane
    its b0 and b1 of both n8 tiles."""
    din, dout = w.shape
    kp, np_ = pad16(din), pad16(dout)
    wp = torch.zeros((kp, np_), dtype=torch.bfloat16, device=w.device)
    wp[:din, :dout] = w
    # row 16 kc + 8 kh + 2 t + kk, column 16 p + 8 nh + g
    # -> [p][kc][g][t][nh][kh][kk]
    return (wp.view(kp // 16, 2, 4, 2, np_ // 16, 2, 8)
            .permute(4, 0, 6, 2, 5, 1, 3).reshape(np_ // 16, kp // 16, 32, 8)
            .contiguous())


@torch.no_grad()
def pack_policy_weights(policy) -> PolicyWeights:
    """Re-lays a ``parallel.ppo.ActorCritic`` into the kernels' operands."""
    def dense(layer):
        return (layer.weight.detach().t().to(torch.bfloat16).contiguous(),
                layer.bias.detach().float().contiguous())

    w1, b1 = dense(policy.trunk1)
    w2, b2 = dense(policy.trunk2)
    wm, bm = dense(policy.mu)
    return PolicyWeights(w1=w1, b1=b1, w2=w2, b2=b2, wm=wm, bm=bm,
                         sigma=torch.exp(policy.log_std.detach().float()),
                         w1f=b_fragments(w1), w2f=b_fragments(w2),
                         wmf=b_fragments(wm))


def check_policy_weights(w: PolicyWeights, D: int, H: int, n: int, dev):
    """Raises unless ``w`` is an actor (D, H, n) on ``dev`` in the kernels'
    layouts."""
    def frag(din, dout):
        return (pad16(dout) // 16, pad16(din) // 16, 32, 8)

    bf16, f32 = torch.bfloat16, torch.float32
    for name, x, shape, dt in (
            ("w1f", w.w1f, frag(D, H), bf16), ("b1", w.b1, (H,), f32),
            ("w2f", w.w2f, frag(H, H), bf16), ("b2", w.b2, (H,), f32),
            ("wmf", w.wmf, frag(H, n), bf16), ("bm", w.bm, (n,), f32),
            ("sigma", w.sigma, (n,), f32)):
        check(name, x, dt, shape, dev)


def policy_weight_args(w: PolicyWeights) -> list:
    """The kernels' actor arguments: w1, b1, w2, b2, wm, bm, sigma."""
    return [x.data_ptr() for x in (w.w1f, w.b1, w.w2f, w.b2, w.wmf, w.bm,
                                   w.sigma)]


def ev_fused_layout(n: int, k: int = 36) -> dict:
    """Learner block of ``ev_policy_segment``: (T, B, width) bf16 rows,
    columns [0:obs_cols] the canonical flat obs (timestep | est_departures
    | demands | prev_moer | forecast), [u_lo:u_lo + n] the pre-squash u."""
    d = 2 + 2 * n + k
    return {"width": d + n, "obs_cols": d, "u_lo": d}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _zero_state(days: torch.Tensor, n: int) -> EVState:
    B, dev = days.shape[0], days.device
    return EVState(
        day=days, t=torch.zeros(B, dtype=torch.long, device=dev),
        plugged=torch.zeros((B, n), dtype=torch.bool, device=dev),
        dep=torch.zeros((B, n), dtype=torch.long, device=dev),
        est_dep=torch.zeros((B, n), dtype=torch.long, device=dev),
        demand=torch.zeros((B, n), dtype=torch.float32, device=dev))


def ev_segment_ref(params: EVParams, days: torch.Tensor, T: int,
                   actions: torch.Tensor | None = None, seed: int = 0,
                   record_actions: bool = False,
                   matvecs: torch.Tensor | None = None):
    """Plain version of :func:`ev_segment`. Returns (out (T, B, 4) rows
    reward | profit | carbon_cost | excess_charge, the actions used
    (T, B, n) if ``record_actions`` else None). It runs every projection
    iteration of every step and adds its mat-vecs with C to ``matvecs``:
    C' y and C x per iteration, the reward's C p, and FISTA's final C' y
    or ADMM's first C x."""
    n, B, dev = params.n_stations, days.shape[0], params.device
    if matvecs is not None:
        per_step = 2 * int(params.proj.iters) + 2 if params.project_action \
            else 1
        matvecs += B * T * per_step
    gen = seeded(dev, seed) if actions is None else None
    st = _zero_state(days, n)
    out = torch.empty((T, B, 4), dtype=torch.float32, device=dev)
    acts_out = (torch.empty((T, B, n), dtype=torch.float32, device=dev)
                if record_actions else None)
    for t in range(T):
        a = (actions[t] if actions is not None else
             torch.rand((B, n), generator=gen, device=dev))
        a = torch.clamp(a, 0.0, 1.0)
        if acts_out is not None:
            acts_out[t] = a
        st, reward, terms = advance(params, st, a,
                                    params.step_table[days, t])
        out[t] = torch.stack([reward, terms["profit"], terms["carbon_cost"],
                              terms["excess_charge"]], -1)
    return out, acts_out


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Rounds to bf16 and back to f32 (the kernel's cast points)."""
    return x.to(torch.bfloat16).float()


def _actor_ref(w: PolicyWeights, obs_bf16: torch.Tensor) -> torch.Tensor:
    """mu from bf16 obs: bf16 operands, f32 accumulation, f32 bias/tanh."""
    h = _bf(torch.tanh(obs_bf16.float() @ w.w1.float() + w.b1))
    h = _bf(torch.tanh(h @ w.w2.float() + w.b2))
    return h @ w.wm.float() + w.bm


def _policy_obs(st: EVState, moer_row: torch.Tensor, t: int, k: int
                ) -> torch.Tensor:
    """Flat obs of the pre-event state at step t (canonical order)."""
    B, dev = st.day.shape[0], st.day.device
    est = torch.where(st.plugged, (st.est_dep - t).float(), 0.0)
    dem = torch.where(st.plugged, st.demand, 0.0)
    tstep = torch.full((B, 1), t, dtype=torch.float32, device=dev) / float(
        MAX_TIMESTEP)
    return torch.cat([tstep, est, dem, moer_row[:, 0:1],
                      moer_row[:, 1:1 + k]], -1)


def ev_policy_segment_ref(params: EVParams, weights: PolicyWeights,
                          days: torch.Tensor, T: int,
                          noise: torch.Tensor | None = None, seed: int = 0,
                          env_offset: int = 0):
    """Plain version of :func:`ev_policy_segment`. Returns (out (T, B, 4),
    learner block (T, B, D + n) bf16). Without ``noise`` env e draws as
    global env ``env_offset + e`` (``wrap.env_normals``)."""
    n, B, dev = params.n_stations, days.shape[0], params.device
    k = params.moer_forecast_steps
    st = _zero_state(days, n)
    out = torch.empty((T, B, 4), dtype=torch.float32, device=dev)
    lrn = torch.empty((T, B, ev_fused_layout(n, k)["width"]),
                      dtype=torch.bfloat16, device=dev)
    for t in range(T):
        obs = _policy_obs(st, params.moer[days, t], t, k).to(torch.bfloat16)
        mu = _actor_ref(weights, obs)
        z = (noise[t] if noise is not None else
             env_normals(dev, seed, t, env_offset, B, n))
        u = mu + weights.sigma * z
        lrn[t] = torch.cat([obs, u.to(torch.bfloat16)], -1)
        st, reward, terms = advance(params, st, torch.tanh(u) * 0.5 + 0.5,
                                    params.step_table[days, t])
        out[t] = torch.stack([reward, terms["profit"], terms["carbon_cost"],
                              terms["excess_charge"]], -1)
    return out, lrn


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_OP_ARGS = [P, P, P, P, P, I, I, I, I, I]
_SIGNATURES = {
    "ev_segment_launch": _OP_ARGS + [P, F, F, P, I, I, P, I, I, P, U64, P, P,
                                     P, P],
    "ev_policy_segment_launch": _OP_ARGS + [
        P, P, P, P, P, P, P, I, I, P, I, I, P, I, I, P, I, I, P, U64, I, P,
        P, P],
    "ev_policy_segment_ctas_per_sm": [I, I, I, PI],
    "ev_segment_ctas_per_sm": [I, I, PI, PI, PI, PI, PI],
}


def _lib() -> ctypes.CDLL:
    return bind("ev_rollout", _SIGNATURES)


def _check_common(params: EVParams, days: torch.Tensor, T: int):
    table, proj, dev = params.step_table, params.proj, params.device
    n, m2 = params.n_stations, int(proj.C.shape[0])
    if n > _MAX_STATIONS or m2 > _MAX_CONE_ROWS:
        raise ValueError(f"the EV kernels hold <= {_MAX_STATIONS} stations "
                         f"and <= {_MAX_CONE_ROWS // 2} cones")
    if table.ndim != 3 or table.shape[2] < 3 * n + 1 \
            or not 0 < T <= table.shape[1]:
        raise ValueError(f"bad day table {tuple(table.shape)} for T={T}")
    check("step_table", table, torch.float32, table.shape, dev)
    check("days", days, torch.long, (days.shape[0],), dev)
    if days.numel():
        trace.count("host_syncs.ev_days_min")
        if int(days.min()) < 0:
            raise ValueError("reset days out of range")
        trace.count("host_syncs.ev_days_max")
        if int(days.max()) >= table.shape[0]:
            raise ValueError("reset days out of range")
    check("C", proj.C, torch.float32, (m2, n), dev)
    if isinstance(proj, SOCProjection):
        check("K", proj.K, torch.float32, (n, n), dev)
    else:
        check("step", proj.step, torch.float32, (m2 // 2,), dev)
    for name, x, size in (("radii", proj.radii, m2 // 2),
                          ("magnitudes", params.magnitudes, m2 // 2),
                          ("min_pilots", params.min_pilots, n)):
        check(name, x, torch.float32, (size,), dev)
    return dev, n, m2


def _op_args(params: EVParams, n: int, m2: int) -> list:
    """The kernels' operator arguments; ADMM passes no dual steps."""
    proj = params.proj
    admm = isinstance(proj, SOCProjection)
    return [proj.C.data_ptr(), proj.radii.data_ptr(),
            None if admm else proj.step.data_ptr(),
            params.magnitudes.data_ptr(), params.min_pilots.data_ptr(), n,
            m2, int(proj.iters), int(getattr(proj, "restart", False)),
            int(params.project_action)]


def _admm_args(params: EVParams) -> list:
    """``ev_segment_launch``'s K, rho, alpha: K null for dual FISTA."""
    proj = params.proj
    if isinstance(proj, SOCProjection):
        return [proj.K.data_ptr(), proj.rho, proj.alpha]
    return [None, 0.0, 0.0]


def ev_segment(params: EVParams, days: torch.Tensor, T: int,
               actions: torch.Tensor | None = None, seed: int = 0,
               record_actions: bool = False,
               matvecs: torch.Tensor | None = None):
    """One episode segment of B = len(days) envs from reset, T <= 288
    steps; ``days`` (B,) int64. ``actions`` (T, B, n) prescribed, else
    U[0, 1) draws seeded by ``seed``. Returns (out (T, B, 4) f32 rows
    reward | profit | carbon_cost | excess_charge, the actions used (T, B,
    n) if ``record_actions`` else None). The projection is
    ``params.proj``'s: dual FISTA or ADMM. ``matvecs``, a 0-d int64 tensor
    on the params' device, gets the mat-vecs with C that the kernel ran
    added to it: it skips C' y where y is 0, and stops an env step's FISTA
    once an iteration repeats the one before (the rest would repeat it
    exactly), so a projected step runs at least the first iteration's C x
    and the reward's C p. ADMM runs every iteration, and a K mat-vec in
    each besides."""
    if not on_card(params.step_table, "the EV kernels"):
        trace.end("ev.prelaunch")
        return ev_segment_ref(params, days, T, actions, seed, record_actions,
                              matvecs)
    dev, n, m2 = _check_common(params, days, T)
    if matvecs is not None:
        check("matvecs", matvecs, torch.long, (), dev)
    table = params.step_table
    B = days.shape[0]
    if actions is not None:
        check("actions", actions, torch.float32, (T, B, n), dev)
    out = torch.empty((T, B, 4), dtype=torch.float32, device=dev)
    acts_out = (torch.empty((T, B, n), dtype=torch.float32, device=dev)
                if record_actions else None)
    trace.end("ev.prelaunch")
    with torch.cuda.device(dev):
        err = _lib().ev_segment_launch(
            *_op_args(params, n, m2), *_admm_args(params),
            table.data_ptr(), table.shape[2],
            table.shape[1], days.data_ptr(), B, T, ptr(actions),
            seed % 2 ** 64, out.data_ptr(), ptr(acts_out), ptr(matvecs),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "ev_segment")
    ev_segment.launches += 1
    return out, acts_out


count_launches(ev_segment)


def ev_policy_segment(params: EVParams, weights: PolicyWeights,
                      days: torch.Tensor, T: int,
                      noise: torch.Tensor | None = None, seed: int = 0,
                      env_offset: int = 0):
    """One episode segment with the actor in the kernel; the obs channels
    come from the MOER pack ``params.moer``. ``noise`` (T, B, n) prescribed
    normals, else Box–Muller draws seeded by ``seed``, env e drawing as
    global env ``env_offset + e`` (a data-parallel rank's slice). Returns (out
    (T, B, 4) f32, learner block (T, B, D + n) bf16; see
    :func:`ev_fused_layout`). The dual-FISTA operator only: the policy
    kernel has no ADMM branch (nor has the TPU kernel)."""
    if isinstance(params.proj, SOCProjection):
        raise ValueError("ev_policy_segment computes the dual-FISTA "
                         "projection only, not ADMM")
    if not on_card(params.step_table, "the EV kernels"):
        trace.end("ev.prelaunch")
        return ev_policy_segment_ref(params, weights, days, T, noise, seed,
                                     env_offset)
    dev, n, m2 = _check_common(params, days, T)
    table, moer, k = params.step_table, params.moer, params.moer_forecast_steps
    B = days.shape[0]
    D = ev_fused_layout(n, k)["obs_cols"]
    H = weights.w1.shape[1]
    if moer.ndim != 3 or moer.shape[:2] != table.shape[:2] \
            or moer.shape[2] < 1 + k:
        raise ValueError(f"bad moer pack {tuple(moer.shape)}")
    check("moer", moer, torch.float32, moer.shape, dev)
    check_policy_weights(weights, D, H, n, dev)
    if noise is not None:
        check("noise", noise, torch.float32, (T, B, n), dev)
    if env_offset < 0:
        raise ValueError(f"env_offset {env_offset} < 0")
    out = torch.empty((T, B, 4), dtype=torch.float32, device=dev)
    lrn = torch.empty((T, B, D + n), dtype=torch.bfloat16, device=dev)
    trace.end("ev.prelaunch")
    with torch.cuda.device(dev):
        err = _lib().ev_policy_segment_launch(
            *_op_args(params, n, m2), *policy_weight_args(weights), D, H,
            table.data_ptr(), table.shape[2], table.shape[1],
            moer.data_ptr(), moer.shape[2], k, days.data_ptr(), B, T,
            ptr(noise), seed % 2 ** 64, env_offset,
            out.data_ptr(), lrn.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "ev_policy_segment")
    ev_policy_segment.launches += 1
    return out, lrn


count_launches(ev_policy_segment)


def ev_policy_occupancy(D: int, H: int, n: int) -> int:
    """CTAs of ``ev_policy_segment``'s kernel (16 warps each) resident per
    SM for an actor (D, H, n), on the current card."""
    return ctas_per_sm(_lib().ev_policy_segment_ctas_per_sm, D, H, n)[0]


def ev_segment_occupancy(m2: int, admm: bool = False) -> dict:
    """``ev_segment``'s kernel instance for ``m2`` cone rows and the
    operator (``admm``) on the current card: CTAs resident per SM
    (``ctas``), warps a CTA (``warps``), envs a warp (``envs_per_warp``:
    the ADMM kernel steps several envs a warp), registers a thread
    (``registers``) and local memory a thread in bytes (``local_bytes``,
    the compiler's spills)."""
    keys = ("ctas", "warps", "envs_per_warp", "registers", "local_bytes")
    return dict(zip(keys, ctas_per_sm(_lib().ev_segment_ctas_per_sm, m2,
                                      int(admm))))
