"""The port's replay ring (sustaingym_tpu_torch.parallel.replay) against the
JAX package's parallel.replay on the same numpy rings: block and per-step
writes, a misaligned ``written``, a wrapping per-step rollout, sampling on
prescribed slots in both modes, and the port's own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.parallel import replay as jr
from sustaingym_tpu_torch.parallel import replay as tr

CAP, ENVS, D = 8, 5, 3


def _rings(seed=0, agents=None):
    """The same random ring as numpy, JAX and torch dicts."""
    rng = np.random.default_rng(seed)
    lead = (ENVS,) if agents is None else (ENVS, agents)
    ring = {"obs": rng.normal(size=(CAP,) + lead + (D,)).astype(np.float32),
            "act": rng.integers(0, 4, (CAP,) + lead + (2,)).astype(np.int32),
            "reward": rng.normal(size=(CAP,) + lead).astype(np.float32)}
    return (ring, {k: jnp.asarray(v) for k, v in ring.items()},
            {k: torch.from_numpy(v.copy()) for k, v in ring.items()})


def _block(rng, T, agents=None):
    lead = (T, ENVS) if agents is None else (T, ENVS, agents)
    return {"obs": rng.normal(size=lead + (D,)).astype(np.float32),
            "act": rng.integers(0, 4, lead + (2,)).astype(np.int32),
            "reward": rng.normal(size=lead).astype(np.float32)}


def _equal(jring, tring):
    for k in jring:
        np.testing.assert_array_equal(tring[k].numpy(), np.asarray(jring[k]))


def test_init_ring_shapes_and_zeros():
    ring = tr.init_ring(CAP, {"obs": ((ENVS, 2, D), torch.float32),
                              "act": ((ENVS, 2, 1), torch.long)}, "cpu")
    assert ring["obs"].shape == (CAP, ENVS, 2, D)
    assert ring["act"].dtype == torch.long and not ring["act"].any()


@pytest.mark.parametrize("written", [0, 4, 5, 11, 13])
@pytest.mark.parametrize("agents", [None, 2])
def test_write_block_matches_jax(written, agents):
    """T = 4 into capacity 8: aligned starts, and misaligned ``written``
    (5, 11, 13: a resume under another rollout length) rounded down to the
    T-aligned slot, as the JAX package rounds them."""
    _, jring, tring = _rings(1, agents)
    block = _block(np.random.default_rng(2), 4, agents)
    jout = jr.write_block(jring, {k: jnp.asarray(v) for k, v in
                                  block.items()},
                          jnp.asarray(written, jnp.int32), CAP)
    tout = tr.write_block(tring, {k: torch.from_numpy(v) for k, v in
                                  block.items()},
                          torch.tensor(written), CAP)
    assert tout is tring
    _equal(jout, tring)


def test_write_transition_wraps_as_jax():
    """A per-step rollout of T = 6 into capacity 4 (tests/test_sac.py:51's
    configuration): each step into slot written % 4, written advancing by
    one; the ring holds the last four."""
    _, jring, tring = _rings(3)
    cap = 4
    jring = {k: v[:cap] for k, v in jring.items()}
    tring = {k: v[:cap].clone() for k, v in tring.items()}
    block = _block(np.random.default_rng(4), 6)
    jw, tw = jnp.asarray(2, jnp.int32), torch.tensor(2)
    for t in range(6):
        jring = jr.write_transition(
            jring, {k: jnp.asarray(v[t]) for k, v in block.items()}, jw, cap)
        tr.write_transition(tring, {k: torch.from_numpy(v[t])
                                    for k, v in block.items()}, tw, cap)
        jw, tw = jw + 1, tw.add_(1)
    _equal(jring, tring)
    assert int(tw) == 8
    # slot (2 + t) % 4 holds step t for the last four steps
    np.testing.assert_array_equal(tring["reward"][[0, 1, 2, 3]].numpy(),
                                  block["reward"][[2, 3, 4, 5]])


@pytest.mark.parametrize("per_env", [False, True])
@pytest.mark.parametrize("written", [3, 8, 21])
def test_sampling_matches_jax_on_its_own_slots(per_env, written):
    """sample_transitions on the slots that jax.random.randint draws inside
    the JAX function (its key, shape and bound min(written, cap)) returns
    the JAX sample bit for bit, in both modes; the slots lie below
    min(written, capacity)."""
    _, jring, tring = _rings(5)
    key = jax.random.PRNGKey(written)
    jw = jnp.asarray(written, jnp.int32)
    jb = jr.sample_transitions(jring, jw, CAP, 4, key, per_env_sample=per_env)
    shape = (4, ENVS) if per_env else (4,)
    idx = np.asarray(jax.random.randint(
        key, shape, 0, jnp.maximum(jnp.minimum(jw, CAP), 1)))
    assert idx.max() < min(written, CAP)
    tb = tr.sample_transitions(tring, torch.tensor(written), CAP, 4,
                               per_env_sample=per_env,
                               idx=torch.tensor(idx, dtype=torch.long))
    _equal(jb, tb)


def test_port_draws_satisfy_the_sampling_properties():
    """tests/test_sac.py::test_replay_sampling_modes on the port's own
    draws: (batch_per_env, num_envs, ...) batches of written slots, obs
    consistent with their reward's slot, one shared slot per row in the
    slot mode; per-env draws cover several slots per row."""
    ring = tr.init_ring(CAP, {"obs": ((ENVS, D), torch.float32),
                              "reward": ((ENVS,), torch.float32)}, "cpu")
    written = torch.tensor(0)
    for i in range(CAP):
        tr.write_transition(ring, {"obs": torch.full((ENVS, D), float(i)),
                                   "reward": torch.full((ENVS,), float(i))},
                            written, CAP)
        written.add_(1)
    gen = torch.Generator().manual_seed(0)
    for per_env in (False, True):
        batch = tr.sample_transitions(ring, written, CAP, 4, gen,
                                      per_env_sample=per_env)
        assert batch["obs"].shape == (4, ENVS, D)
        assert batch["reward"].shape == (4, ENVS)
        assert set(batch["reward"].flatten().tolist()) <= set(
            float(i) for i in range(CAP))
        np.testing.assert_array_equal(batch["obs"][..., 0].numpy(),
                                      batch["reward"].numpy())
        rows = batch["reward"].numpy()
        if per_env:
            assert any(len(set(row)) > 1 for row in rows)
        else:
            assert all(len(set(row)) == 1 for row in rows)


def test_ring_slots_stay_below_filled():
    """floor(u * max(filled, 1)), clamped below max(filled, 1): a product
    that rounds up to ``filled`` (here u = 1, the top of the interval) is
    clamped; an empty ring draws slot 0; a partly filled ring never draws
    past its end, a full one draws every slot."""
    u = torch.tensor([0.0, 0.5, 1.0 - 2 ** -24, 1.0])
    assert tr.ring_slots(u, torch.tensor(6), CAP).tolist() == [0, 3, 5, 5]
    assert tr.ring_slots(u, torch.tensor(0), CAP).tolist() == [0, 0, 0, 0]
    assert tr.ring_slots(u, torch.tensor(50), CAP).tolist() == [0, 4, 7, 7]
    gen = torch.Generator().manual_seed(1)
    idx = tr.ring_slots(torch.rand(10000, generator=gen), torch.tensor(3),
                        CAP)
    assert set(idx.tolist()) == {0, 1, 2}
    idx = tr.ring_slots(torch.rand(10000, generator=gen), torch.tensor(30),
                        CAP)
    assert set(idx.tolist()) == set(range(CAP))
