"""The hand-written CUDA kernels of sustaingym_tpu_torch.ops.cuda
(ev_rollout, exog_gather, cogen_rollout) against their plain PyTorch
versions on the card, at a small size. Marked ``gpu``; each test skips
when no CUDA device is present. On a card:

    python -m pytest tests/test_torch_gpu_kernels.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.ops.cuda import cogen_rollout as KB
from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
from sustaingym_tpu_torch.ops.cuda import exog_gather as KA
from sustaingym_tpu_torch.parallel import init_policy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _setup(dev, site, project, batch=64):
    env, p = make("evcharging", site=site, project_action=project,
                  device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    days = torch.randint(p.n_days, (batch,), generator=g, device=dev)
    return env, p, days, g


@pytest.mark.parametrize("site,project", [("caltech", True), ("jpl", True),
                                          ("caltech", False)])
def test_ev_segment_kernel_matches_plain(cuda, site, project):
    _, p, days, g = _setup(cuda, site, project)
    T = 288
    acts = torch.rand((T, days.shape[0], p.n_stations), generator=g,
                      device=cuda)
    before = K.ev_segment.launches
    ko, _ = K.ev_segment(p, days, T, actions=acts)
    torch.cuda.synchronize()
    assert K.ev_segment.launches == before + 1
    ro, _ = K.ev_segment_ref(p, days, T, actions=acts)
    torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
    d = (ko[..., 0] - ro[..., 0]).abs().cpu().numpy()
    assert np.quantile(d, 0.99) < 1e-4 and d.mean() < 1e-4
    # RNG mode: the plain version replays the kernel's recorded draws
    ko, a = K.ev_segment(p, days, T, seed=3, record_actions=True)
    ro, _ = K.ev_segment_ref(p, days, T, actions=a)
    torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


@pytest.mark.parametrize("site,project", [("caltech", True), ("jpl", False)])
def test_ev_policy_segment_kernel_matches_plain(cuda, site, project):
    _, p, days, g = _setup(cuda, site, project)
    n, k, T, H = p.n_stations, p.moer_forecast_steps, 288, 64
    D = 2 + 2 * n + k
    w = K.pack_policy_weights(init_policy(D, n, H, g, cuda))
    noise = torch.randn((T, days.shape[0], n), generator=g, device=cuda)
    ko, kl = K.ev_policy_segment(p, w, days, T, noise=noise)
    ro, rl = K.ev_policy_segment_ref(p, w, days, T, noise=noise)
    torch.testing.assert_close(ko[:12, :, 0], ro[:12, :, 0], rtol=2e-4,
                               atol=2e-5)
    kl, rl = kl.float(), rl.float()
    assert torch.equal(kl[..., 1:1 + n], rl[..., 1:1 + n])     # est obs
    dd = (kl[..., 1 + n:1 + 2 * n] - rl[..., 1 + n:1 + 2 * n]).abs()
    assert float((dd > 1e-3).float().mean()) < 0.01
    du = (kl[..., D:] - rl[..., D:]).abs().cpu().numpy()
    assert np.quantile(du, 0.99) < 0.02
    dr = (ko[..., 0] - ro[..., 0]).abs().cpu().numpy()
    assert np.quantile(dr, 0.99) < 1e-4 and dr.mean() < 1e-4


def test_ragged_batch(cuda):
    """A batch that fills neither the 8-warp simulation CTAs nor the
    16-env policy tiles."""
    _, p, days, g = _setup(cuda, "jpl", True, batch=37)
    n, k, T = p.n_stations, p.moer_forecast_steps, 24
    acts = torch.rand((T, 37, n), generator=g, device=cuda)
    ko, _ = K.ev_segment(p, days, T, actions=acts)
    ro, _ = K.ev_segment_ref(p, days, T, actions=acts)
    torch.testing.assert_close(ko, ro, rtol=2e-4, atol=2e-5)
    w = K.pack_policy_weights(init_policy(2 + 2 * n + k, n, 32, g, cuda))
    noise = torch.randn((T, 37, n), generator=g, device=cuda)
    ko, kl = K.ev_policy_segment(p, w, days, T, noise=noise)
    ro, rl = K.ev_policy_segment_ref(p, w, days, T, noise=noise)
    torch.testing.assert_close(ko, ro, rtol=2e-4, atol=2e-5)
    assert torch.equal(kl[..., :1 + n], rl[..., :1 + n])


def test_kernel_wrappers_validate_inputs(cuda):
    _, p, days, _ = _setup(cuda, "caltech", True)
    with pytest.raises(ValueError):
        K.ev_segment(p, days.int(), 12)
    with pytest.raises(ValueError):
        K.ev_segment(p, days, 12,
                     actions=torch.zeros((12, 3, 54), device=cuda))
    with pytest.raises(ValueError):
        K.ev_segment(p, days + p.n_days, 12)


@pytest.mark.parametrize("rows,cols,batch,length", [
    (27400, 7, 300, 100),    # the cogen ambient pack, one padded day each
    (2890, 201, 100, 96),    # a wide table (the JAX hbm_slice_gather case)
    (513, 1, 37, 17),        # ragged: a batch that fills no CTA
])
def test_slice_gather_kernel_bit_equal(cuda, rows, cols, batch, length):
    g = torch.Generator(device=cuda).manual_seed(rows)
    table = torch.rand((rows, cols), generator=g, device=cuda)
    starts = torch.randint(rows - length + 1, (batch,), generator=g,
                           device=cuda)
    before = KA.episode_slice_gather.launches
    out = KA.episode_slice_gather(table, starts, length)
    torch.cuda.synchronize()
    assert KA.episode_slice_gather.launches == before + 1
    assert torch.equal(out, KA.episode_slice_gather_ref(table, starts, length))
    with pytest.raises(ValueError):
        KA.episode_slice_gather(table, starts + rows, length)


def _cogen(dev, batch):
    env, p = make("cogen", device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    days = torch.randint(p.n_days - 1, (batch,), generator=g, device=dev)
    return env, p, days, env.sample_action(p, g, batch), g


def test_cogen_segment_kernel_matches_plain(cuda):
    """Prescribed actions drawn uniformly over the box, then RNG mode with
    the plain version replaying the kernel's action rows: reward and info
    at rtol 2e-5 / atol 0.2, action rows bit-equal."""
    env, p, days, prev, g = _cogen(cuda, 300)
    T = 96
    low = torch.as_tensor(env.action_space(p).low, dtype=torch.float32,
                          device=cuda)
    high = torch.as_tensor(env.action_space(p).high, dtype=torch.float32,
                           device=cuda)
    acts = low + torch.rand((T, 300, 15), generator=g, device=cuda) * (
        high - low)
    before = KB.cogen_segment.launches
    ko = KB.cogen_segment(p, days, prev, T, actions=acts)
    torch.cuda.synchronize()
    assert KB.cogen_segment.launches == before + 1
    torch.testing.assert_close(ko, KB.cogen_segment_ref(p, days, prev, T,
                                                        actions=acts),
                               rtol=2e-5, atol=0.2)
    assert torch.equal(ko[:15], acts.permute(2, 0, 1))
    ko = KB.cogen_segment(p, days, prev, T, seed=9)
    a = ko[:15].permute(1, 2, 0).contiguous()
    ro = KB.cogen_segment_ref(p, days, prev, T, actions=a)
    assert torch.equal(ko[:15], ro[:15])
    torch.testing.assert_close(ko, ro, rtol=2e-5, atol=0.2)
    assert set(a[..., 14].unique().tolist()) <= set(range(1, 13))


def test_cogen_fused_rollout_on_card(cuda):
    """The simulation tier launches the gather and the episode kernel once
    per episode; across the boundary the obs splice in the next reset."""
    env, p, _, _, g = _cogen(cuda, 1)
    counts = (KA.episode_slice_gather.launches, KB.cogen_segment.launches)
    roll = env.fused_rollout(p, 512, 98, generator=g)
    assert (KA.episode_slice_gather.launches - counts[0],
            KB.cogen_segment.launches - counts[1]) == (2, 2)
    assert roll.reward.shape == (98, 512)
    assert bool(torch.isfinite(roll.reward).all())
    assert bool(roll.obs["Time"][95].eq(0).all())
