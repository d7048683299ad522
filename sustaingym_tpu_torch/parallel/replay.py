"""The on-device replay ring of the off-policy learners (SAC, DQN, DDPG):
``sustaingym_tpu.parallel.replay`` on one card.

The ring is a fixed-size time axis over the env batch: ``(capacity,
num_envs[, n_agents], ...)`` per field. ``written``, the count of
transitions written so far, is a 0-d int64 tensor on the ring's device,
and every slot index is computed there from it: the writes and the
sampling never read the device from the host, so a CUDA graph captures
them. The writes are in place (``index_copy_``).

Sampling modes (``per_env_sample``), as in the JAX package:

- ``False`` (default): ``batch_per_env`` shared ring slots, each a whole
  ``(num_envs, ...)`` slice;
- ``True``: ``batch_per_env`` slots drawn for each env.

``torch.randint`` takes its bound from the host, and the bound here is
``min(written, capacity)`` on the device. So a slot is drawn as
``floor(u * max(filled, 1))`` with ``u ~ U[0, 1)`` float32 from the
generator, clamped to ``max(filled, 1) - 1``: float32 rounding of ``u *
filled`` can reach ``filled`` itself.
"""
from __future__ import annotations

import torch

__all__ = ["init_ring", "write_transition", "write_block",
           "sample_transitions", "ring_slots"]


def init_ring(capacity: int, fields: dict[str, tuple[tuple, torch.dtype]],
              device) -> dict[str, torch.Tensor]:
    """The zeroed ring: ``fields`` maps name -> (per-slot shape with the
    env / agent lead, dtype)."""
    return {name: torch.zeros((capacity,) + tuple(shape), dtype=dtype,
                              device=device)
            for name, (shape, dtype) in fields.items()}


def write_transition(buffer: dict, tr: dict, written: torch.Tensor,
                     capacity: int) -> dict:
    """Writes one transition dict into slot ``written % capacity`` in
    place; returns ``buffer``. ``written`` is not advanced."""
    slot = (written % capacity).reshape(1)
    for k, ring in buffer.items():
        ring.index_copy_(0, slot, tr[k].to(ring.dtype)[None])
    return buffer


def write_block(buffer: dict, block: dict, written: torch.Tensor,
                capacity: int) -> dict:
    """Writes a whole (T, ...) transition block in place from slot
    ``(written % capacity) // T * T``; returns ``buffer``.

    Callers advance ``written`` by T a call and guarantee ``capacity % T
    == 0``, so the block never wraps. A ``written`` that is not a multiple
    of T (a checkpoint resumed under another rollout length) starts the
    block at the T-aligned slot below it, as the JAX package does: it
    overwrites the tail of the previous block, never a window past the
    ring's end."""
    T = next(iter(block.values())).shape[0]
    start = (written % capacity) // T * T
    slots = start + torch.arange(T, device=written.device)
    for k, ring in buffer.items():
        ring.index_copy_(0, slots, block[k].to(ring.dtype))
    return buffer


def ring_slots(u: torch.Tensor, written: torch.Tensor, capacity: int
               ) -> torch.Tensor:
    """Ring slots below ``min(written, capacity)`` from uniforms ``u`` in
    [0, 1): ``floor(u * max(filled, 1))``, clamped below
    ``max(filled, 1)``."""
    n = torch.clamp(torch.clamp(written, max=capacity), min=1)
    idx = torch.floor(u * n.to(u.dtype)).long()
    return torch.minimum(idx, n - 1)


def sample_transitions(buffer: dict, written: torch.Tensor, capacity: int,
                       batch_per_env: int,
                       generator: torch.Generator | None = None,
                       per_env_sample: bool = False,
                       idx: torch.Tensor | None = None) -> dict:
    """Samples ``batch_per_env`` steps per env: a dict of (batch_per_env,
    num_envs, ...) fields. ``idx`` prescribes the slots ((batch_per_env,)
    shared, or (batch_per_env, num_envs) per env); else they are drawn
    from ``generator`` (module docstring)."""
    envs = buffer["reward"].shape[1]
    if idx is None:
        shape = (batch_per_env, envs) if per_env_sample else (batch_per_env,)
        u = torch.rand(shape, generator=generator, device=generator.device)
        idx = ring_slots(u, written, capacity)
    if per_env_sample:
        cols = torch.arange(envs, device=idx.device)
        return {k: v[idx, cols] for k, v in buffer.items()}
    return {k: v.index_select(0, idx) for k, v in buffer.items()}
