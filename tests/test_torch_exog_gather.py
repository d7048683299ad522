"""Plain PyTorch version of the episode slice-gather kernel
(sustaingym_tpu_torch.ops.cuda.exog_gather) against the JAX package's XLA
semantics (_xla_slice_gather) on the shapes of tests/test_ops_pallas.py:
bit-equal, since both are pure copies."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.ops.pallas.exog_gather import _xla_slice_gather
from sustaingym_tpu_torch.ops.cuda import exog_gather as K


def _inputs(rows, cols, batch, length, seed):
    rng = np.random.default_rng(seed)
    table = rng.uniform(0, 1, (rows, cols)).astype(np.float32)
    starts = rng.integers(0, rows - length, batch)
    return table, starts


@pytest.mark.parametrize("rows,cols,batch,length", [
    (105408, 4, 64, 288),    # BuildingEnv exog shape
    (105408, 4, 64, 7),      # partial segment
    (1000, 7, 33, 96),       # cogen-like
    (513, 1, 5, 17),         # degenerate small
    (4096, 4, 768, 32),
    (4096, 4, 1025, 32),
    (2890, 201, 33, 96),     # wide tables (the JAX hbm_slice_gather cases)
    (500, 128, 7, 12),
    (2890, 201, 100, 96),
])
def test_slice_gather_matches_jax(rows, cols, batch, length):
    table, starts = _inputs(rows, cols, batch, length, rows + batch)
    ref = np.asarray(_xla_slice_gather(jnp.asarray(table),
                                       jnp.asarray(starts, jnp.int32),
                                       length))
    before = K.episode_slice_gather.launches
    out = K.episode_slice_gather(torch.from_numpy(table),
                                 torch.from_numpy(starts), length)
    assert K.episode_slice_gather.launches == before  # CPU: plain version
    assert out.shape == (batch, length, cols)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_hbm_slice_gather_is_the_same_kernel():
    """The JAX package's wide-table variant computes the same function, so
    the port binds one kernel under both names."""
    assert K.hbm_slice_gather is K.episode_slice_gather
    table, starts = _inputs(2890, 201, 9, 96, 1)
    out = K.hbm_slice_gather(torch.from_numpy(table),
                             torch.from_numpy(starts), 96)
    np.testing.assert_array_equal(
        out.numpy(), np.stack([table[s:s + 96] for s in starts]))


def test_slice_gather_refuses_other_devices():
    table = torch.zeros((10, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.episode_slice_gather(table, torch.zeros(2, dtype=torch.long), 4)
