"""Whole BuildingEnv episode segments: the two hand-written Hopper kernels
of ``csrc/building_rollout.cu``, their plain PyTorch versions and the
learner-block layout.

``building_segment`` replaces ``sustaingym_tpu/ops/pallas/
building_rollout.py::fused_building_segment`` (the simulation tier) and
``building_policy_segment`` replaces ``::fused_building_policy_segment``
(PPO rollouts with the actor in the kernel). What bounds each kernel and
how it is laid out is in the ``.cu`` file.

Both start every env at ``x = target`` on its epoch and read the
exogenous rows ``params.exog[epoch + t]`` of the padded table directly.
Their env step is the TPU kernels' (:func:`segment_step`): the RC update
``[A_d | BD_d] @ [x; occ, ground, out, a, ghi]`` summed column by column
in that order, the comfort error ``(x' - target) * ac``; the env's own
step (``envs/building/env.py``) keeps the JAX env's expressions, which
agree with it to float32 rounding.

Dispatch goes by device: CUDA params always launch the kernel (a build or
launch failure raises), CPU params run the plain version. The kernels
round after every operation of the env step, so on the card the plain
versions are their oracle bit for bit (``building_segment``) and up to the
MLP's summation order (``building_policy_segment``). Each wrapper counts
its launches in its ``launches`` attribute.

Random draws: the kernels use a Philox4x32-10 stream keyed by ``seed``,
the plain versions a ``torch.Generator`` seeded with ``seed``; both draw
U(-ac, ac) actions / standard normals, but not the same numbers.
"""
from __future__ import annotations

import torch

from ...core.graph import count_launches
from ...envs.building.env import (MAX_KERNEL_ZONES, OCCU_COEF, BuildingParams,
                                  _seq_sum, div, kernel_config)
from .ev_rollout import (PolicyWeights, _actor_ref, check_policy_weights,
                         policy_weight_args)
from .wrap import (F, I, P, PI, U64, bind, check, ctas_per_sm, env_normals,
                   on_card, ptr, raise_on, seeded)

__all__ = ["building_fused_layout", "segment_step", "building_segment",
           "building_segment_ref", "building_policy_segment",
           "building_policy_segment_ref", "ops_per_step",
           "building_policy_plan"]


def ops_per_step(n: int) -> int:
    """Float operations of one env step of the simulation kernel at n
    zones, counted from the .cu source: action draw 3n, mean n, occupant
    heat 20, RC product 2n(2n + 4), power 2n, comfort 4n, costs, reward and
    the negated info 6, obs 1."""
    return 3 * n + n + 20 + 2 * n * (2 * n + 4) + 2 * n + 4 * n + 7


def building_fused_layout(n: int) -> dict:
    """Learner block of ``building_policy_segment``: (T, B, width) bf16
    rows, columns [0:obs_cols] the canonical flat obs (temps(n), out,
    ground, ghi, occupower / 1000), [u_lo:u_lo + n] the pre-squash u."""
    return {"width": 2 * n + 4, "obs_cols": n + 4, "u_lo": n + 4}


def _operator(params: BuildingParams) -> torch.Tensor:
    """[A_d | BD_d], (n, 2n + 4): columns x(n), occ, ground, out, a(n),
    ghi."""
    return torch.cat([params.A_d, params.BD_d], 1).contiguous()


def _occupower(avg: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    c = OCCU_COEF
    t2 = avg * avg
    meta2 = meta * meta
    return (c[0] + c[1] * meta + c[2] * meta2
            - (c[3] * avg) * meta + (c[4] * avg) * meta2
            - (c[5] * t2) + (c[6] * t2) * meta - (c[7] * t2) * meta2)


def segment_step(params: BuildingParams, m: torch.Tensor, x: torch.Tensor,
                 a: torch.Tensor, row: torch.Tensor):
    """One env step as the kernels compute it, on (B, ·) tensors: zone
    temps ``x`` (B, n), actions ``a`` (B, n), exogenous rows ``row``
    (B, 4) = [out, ground, ghi, meta]. Returns (x_new, occupant heat,
    comfort cost, power cost), each operation rounded to float32 in the
    kernels' order."""
    n = params.n
    occ = _occupower(div(_seq_sum(x), n), row[:, 3])
    z = [x[:, j] for j in range(n)] + [occ, row[:, 1], row[:, 0]] + [
        a[:, j] for j in range(n)] + [row[:, 2]]
    x_new = z[0][:, None] * m[:, 0]
    for j in range(1, 2 * n + 4):
        x_new = x_new + z[j][:, None] * m[:, j]
    power = torch.sqrt(_seq_sum(a * a))
    diff = (x_new - params.target) * params.ac_map
    comfort = torch.sqrt(_seq_sum(diff * diff))
    return x_new, occ, comfort * params.error_rate, power * params.q_rate


def _check_config(params: BuildingParams, kernel: str):
    if not kernel_config(params) or params.BD_d.shape != (params.n,
                                                          params.n + 4):
        raise ValueError(f"{kernel} computes continuous actions, physics "
                         f"dynamics, the p = 2 reward, float32 and at most "
                         f"{MAX_KERNEL_ZONES} zones")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def building_segment_ref(params: BuildingParams, epochs: torch.Tensor, T: int,
                         actions: torch.Tensor | None = None, seed: int = 0,
                         record_actions: bool = False) -> dict:
    """Plain version of :func:`building_segment`."""
    _check_config(params, "building_segment")
    n, B, dev = params.n, epochs.shape[0], params.device
    gen = seeded(dev, seed) if actions is None else None
    m = _operator(params)
    out = _outputs(n, B, T, dev, record_actions)
    x = params.target.expand(B, n)
    for t in range(T):
        if actions is None:
            u = torch.rand((B, n), generator=gen, device=dev)
            a = (2.0 * u - 1.0) * params.ac_map
        else:
            a = actions[t]
        if record_actions:
            out["actions"][t] = a
        row = params.exog[epochs + t]
        x, occ, comfort_cost, power_cost = segment_step(params, m, x, a, row)
        out["obs"][t] = torch.cat([x, row[:, 0:3], div(occ, 1000.0)[:, None]],
                                  -1)
        out["zone_temperature"][t] = x
        out["reward"][t] = -(power_cost + comfort_cost)
        out["comfort_level"][t] = -comfort_cost
        out["power_consumption"][t] = -power_cost
    return out


def building_policy_segment_ref(params: BuildingParams,
                                weights: PolicyWeights, epochs: torch.Tensor,
                                T: int, noise: torch.Tensor | None = None,
                                seed: int = 0, env_offset: int = 0):
    """Plain version of :func:`building_policy_segment`. Returns (out
    (T, B, 3) f32 reward | comfort_cost | power_cost, learner block
    (T, B, 2n + 4) bf16). Without ``noise`` env e draws as global env
    ``env_offset + e`` (``wrap.env_normals``)."""
    _check_config(params, "building_policy_segment")
    n, B, dev = params.n, epochs.shape[0], params.device
    m = _operator(params)
    out = torch.empty((T, B, 3), dtype=torch.float32, device=dev)
    lrn = torch.empty((T, B, 2 * n + 4), dtype=torch.bfloat16, device=dev)
    x = params.target.expand(B, n)
    # the obs at step t is step t-1's emitted obs; at t = 0 the reset obs
    prev = params.exog[epochs]
    prev_occ = _occupower(div(_seq_sum(x), n), prev[:, 3])
    for t in range(T):
        obs = torch.cat([x, prev[:, 0:3], (prev_occ * (1.0 / 1000.0))[:, None]],
                        -1).to(torch.bfloat16)
        mu = _actor_ref(weights, obs)
        z = (noise[t] if noise is not None else
             env_normals(dev, seed, t, env_offset, B, n))
        u = mu + weights.sigma * z
        lrn[t] = torch.cat([obs, u.to(torch.bfloat16)], -1)
        row = params.exog[epochs + t]
        x, prev_occ, comfort_cost, power_cost = segment_step(
            params, m, x, torch.tanh(u) * params.ac_map, row)
        out[t] = torch.stack([-(power_cost + comfort_cost), comfort_cost,
                              power_cost], -1)
        prev = row
    return out, lrn


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_ENV_ARGS = [P, P, P, F, F, I, P, I, P, I, I]
_SIGNATURES = {
    "building_segment_launch": _ENV_ARGS + [P, U64, P, P, P, P, P, P, P],
    "building_policy_segment_launch": _ENV_ARGS + [
        P, P, P, P, P, P, P, I, P, U64, I, P, P, P],
    "building_policy_segment_launch_plan": _ENV_ARGS + [
        P, P, P, P, P, P, P, I, I, I, I, I, I, P, U64, I, P, P, P],
    "building_policy_segment_plan": [I, I] + [PI] * 7,
}


def _outputs(n: int, B: int, T: int, dev, record_actions: bool) -> dict:
    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return {"obs": f32(T, B, n + 4), "zone_temperature": f32(T, B, n),
            "reward": f32(T, B), "comfort_level": f32(T, B),
            "power_consumption": f32(T, B),
            "actions": f32(T, B, n) if record_actions else None}


def _env_args(params: BuildingParams, m: torch.Tensor, epochs: torch.Tensor,
              T: int, kernel: str) -> list:
    """Checks the env operands and returns the kernels' leading arguments:
    operator, target, ac, q_rate, beta, n, table, rows, epochs, B, T."""
    _check_config(params, kernel)
    dev, n, table = params.device, params.n, params.exog
    B = epochs.shape[0]
    check("exog", table, torch.float32, (table.shape[0], 4), dev)
    if table.data_ptr() % 16:
        raise ValueError(f"{kernel}: the exog table must be 16-byte aligned "
                         f"(one float4 row per step)")
    check("epochs", epochs, torch.long, (B,), dev)
    for name, x in (("target", params.target), ("ac_map", params.ac_map)):
        check(name, x, torch.float32, (n,), dev)
    if T <= 0:
        raise ValueError(f"{kernel}: T = {T}")
    if B:
        lo, hi = torch.stack(torch.aminmax(epochs)).tolist()
        if lo < 0 or hi + T > table.shape[0]:
            raise ValueError(f"{kernel}: epochs in [{lo}, {hi}] leave the "
                             f"{table.shape[0]}-row table for T={T}")
    return [m.data_ptr(), params.target.data_ptr(), params.ac_map.data_ptr(),
            float(params.q_rate), float(params.error_rate), n,
            table.data_ptr(), table.shape[0], epochs.data_ptr(), B, T]


def building_segment(params: BuildingParams, epochs: torch.Tensor, T: int,
                     actions: torch.Tensor | None = None, seed: int = 0,
                     record_actions: bool = False) -> dict:
    """One episode segment of B = len(epochs) envs from ``x = target``,
    T steps with ``epochs + T`` inside the padded table; ``epochs`` (B,)
    int64. ``actions`` (T, B, n) prescribed, else U(-ac, ac) draws in the
    kernel from a Philox stream keyed by ``seed``. Returns the TimeStep
    fields ``obs`` (T, B, n + 4), ``zone_temperature`` (T, B, n),
    ``reward``, ``comfort_level`` and ``power_consumption`` (T, B), and
    ``actions`` (T, B, n), the actions used, if ``record_actions`` (else
    None)."""
    if not on_card(params.exog, "building_segment"):
        return building_segment_ref(params, epochs, T, actions, seed,
                                    record_actions)
    m = _operator(params)
    args = _env_args(params, m, epochs, T, "building_segment")
    n, B, dev = params.n, epochs.shape[0], params.device
    if actions is not None:
        check("actions", actions, torch.float32, (T, B, n), dev)
    out = _outputs(n, B, T, dev, record_actions)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = bind("building_rollout", _SIGNATURES).building_segment_launch(
            *args, ptr(actions), seed % 2 ** 64, out["obs"].data_ptr(),
            out["zone_temperature"].data_ptr(), out["reward"].data_ptr(),
            out["comfort_level"].data_ptr(),
            out["power_consumption"].data_ptr(), ptr(out["actions"]),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "building_segment")
    building_segment.launches += 1
    return out


count_launches(building_segment)


def building_policy_segment(params: BuildingParams, weights: PolicyWeights,
                            epochs: torch.Tensor, T: int,
                            noise: torch.Tensor | None = None,
                            seed: int = 0, env_offset: int = 0):
    """One episode segment with the actor in the kernel. ``weights`` from
    ``ev_rollout.pack_policy_weights`` (trunk1 (n + 4, H)); ``noise``
    (T, B, n) prescribed normals, else Box–Muller draws seeded by
    ``seed``, env e drawing as global env ``env_offset + e`` (a
    data-parallel rank's slice). Returns (out (T, B, 3) f32 reward | comfort_cost |
    power_cost, learner block (T, B, 2n + 4) bf16; see
    :func:`building_fused_layout`). The launcher lays the actor out in the
    card's shared memory (:func:`building_policy_plan`) and refuses one
    whose 16-env activation tiles do not fit."""
    if not on_card(params.exog, "building_policy_segment"):
        return building_policy_segment_ref(params, weights, epochs, T, noise,
                                           seed, env_offset)
    m = _operator(params)
    args = _env_args(params, m, epochs, T, "building_policy_segment")
    n, B, dev = params.n, epochs.shape[0], params.device
    H = weights.b1.shape[0]
    check_policy_weights(weights, n + 4, H, n, dev)
    if noise is not None:
        check("noise", noise, torch.float32, (T, B, n), dev)
    if env_offset < 0:
        raise ValueError(f"env_offset {env_offset} < 0")
    out = torch.empty((T, B, 3), dtype=torch.float32, device=dev)
    lrn = torch.empty((T, B, 2 * n + 4), dtype=torch.bfloat16, device=dev)
    if B == 0:
        return out, lrn
    with torch.cuda.device(dev):
        err = bind("building_rollout",
                   _SIGNATURES).building_policy_segment_launch(
            *args, *policy_weight_args(weights), H, ptr(noise),
            seed % 2 ** 64, env_offset, out.data_ptr(), lrn.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "building_policy_segment")
    building_policy_segment.launches += 1
    return out, lrn


count_launches(building_policy_segment)


def building_policy_plan(n: int, H: int) -> dict:
    """How ``building_policy_segment``'s launcher holds an actor of ``n``
    zones and ``H`` hidden units in the current card's shared memory: env
    tiles of 16 per CTA (``tiles``: 4, 2 or 1, the most whose activation
    tiles fit), ``bias`` (1: b1 and b2 resident), the resident leading k16
    steps per column pair of w1, w2 and wm (``k1``, ``k2``, ``k3``; the
    rest is read from L2), the CTA's shared memory (``smem``, bytes) and
    the CTAs resident per SM (``ctas``). Raises if one tile does not
    fit."""
    keys = ("ctas", "tiles", "bias", "k1", "k2", "k3", "smem")
    return dict(zip(keys, ctas_per_sm(
        bind("building_rollout", _SIGNATURES).building_policy_segment_plan,
        n, H)))
