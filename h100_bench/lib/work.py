"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
(dense rates, NVIDIA's data sheet, at the 700 W power limit) and the
operations and bytes each measured piece of work needs, computed from the
cell's shapes and the reference's counts, never from the program's
counters. Each input is counted read once and each output written once.
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12      # HBM3, bytes/s
PEAK_F32 = 67e12          # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12        # FLOP/s, dense tensor cores


def mlp_forward_flops(obs_dim: int, hidden: int, act_dim: int) -> int:
    """FLOPs of one row through the actor-critic: trunk1, trunk2 and the
    mu and value heads (a multiply and an add per weight)."""
    return 2 * (obs_dim * hidden + hidden * hidden + hidden * (act_dim + 1))


def ppo_step_flops(rows: int, epochs: int, obs_dim: int, hidden: int,
                   act_dim: int) -> int:
    """FLOPs of one PPO train step over ``rows`` samples: the rollout's
    forward, the scoring forward, and each epoch's forward and backward
    (the backward taken as twice the forward)."""
    return rows * mlp_forward_flops(obs_dim, hidden, act_dim) * (
        2 + 3 * epochs)


def bound_s(n_bytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """(least seconds, what binds): the larger of the bytes over the
    memory rate and the operations over their types' peak rates."""
    by_bytes = n_bytes / PEAK_BYTES
    by_ops = f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def ev_table_bytes(n_days: int, n: int) -> int:
    """The EV kernels' day tables, read once: the step table (n_days, 289,
    3n + 39) float32."""
    return n_days * 289 * (3 * n + 39) * 4


def ev_segment_work(batch: int, steps: int, n: int, m2: int, n_days: int,
                    matvecs: int) -> dict:
    """``ev_segment`` (one episode of random actions): the mat-vecs with
    C that the reference needed, 2 m2 n FLOPs each in float32; bytes: the
    step table, the days and the (T, B, 4) float32 outputs."""
    return {"f32_ops": float(matvecs) * 2 * m2 * n,
            "bytes": ev_table_bytes(n_days, n) + batch * 8
            + steps * batch * 4 * 4}


def ev_policy_segment_work(batch: int, steps: int, n: int, m2: int,
                           n_days: int, obs_dim: int, hidden: int,
                           matvecs: int) -> dict:
    """``ev_policy_segment`` (one PPO rollout): the actor's three bf16
    products a step (trunk1, trunk2, mu), the projection's and reward's
    mat-vecs that the reference needed in float32; bytes: the step and
    MOER tables, the bf16 weights, the (T, B, obs_dim + n) bf16 learner
    block and the (T, B, 4) float32 outputs."""
    actor = 2 * (obs_dim * hidden + hidden * hidden + hidden * n)
    weights = 2 * (obs_dim * hidden + hidden * hidden + hidden * n)
    return {"bf16_ops": float(batch) * steps * actor,
            "f32_ops": float(matvecs) * 2 * m2 * n,
            "bytes": ev_table_bytes(n_days, n) + n_days * 289 * 37 * 4
            + weights + batch * 8 + steps * batch * (obs_dim + n) * 2
            + steps * batch * 4 * 4}
