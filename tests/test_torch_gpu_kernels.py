"""The hand-written CUDA kernels of sustaingym_tpu_torch.ops.cuda
(ev_rollout with both projection operators, building_rollout,
exog_gather, cogen_rollout, dc_rollout, lp_solve, ppo_loss) against their plain
PyTorch versions on the card, at a small size, and the captured trainers
(the multi-agent ones too) and evaluation against their eager runs. Marked ``gpu``; each test skips
when no CUDA device is present. On a card:

    python -m pytest tests/test_torch_gpu_kernels.py -q -m gpu
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import random_policy
from sustaingym_tpu_torch.envs import building as tb
from sustaingym_tpu_torch.envs.building import synthetic
from sustaingym_tpu_torch.ops.cuda import building_rollout as K5
from sustaingym_tpu_torch.ops.cuda import cogen_rollout as KB
from sustaingym_tpu_torch.ops.cuda import dc_rollout as K8
from sustaingym_tpu_torch.ops.cuda import ev_rollout as K
from sustaingym_tpu_torch.ops.cuda import exog_gather as KA
from sustaingym_tpu_torch.ops.cuda import lp_solve as K9
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


@pytest.mark.parametrize("site,project,batch", [
    ("caltech", True, 64), ("jpl", True, 64), ("caltech", False, 64),
    ("jpl", True, 37)])
def test_ev_segment_kernel_matches_plain(cuda, site, project, batch):
    """Both sites' kernel instances (caltech 16 cone rows, jpl 18: the
    operator's columns in registers, rounded up to 16 and 24 rows), with
    the projection on and off; 37 envs fill no 8-warp CTA."""
    _, p, days, g = _setup(cuda, site, project, batch)
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
    # near-full rates bind the cones: the projection runs more than one
    # iteration a step before it reaches its fixed point, at most all (two
    # mat-vecs with C each, the final C' y and the reward's C p)
    acts = 0.8 + 0.2 * torch.rand((T, days.shape[0], p.n_stations),
                                  generator=g, device=cuda)
    run = torch.zeros((), dtype=torch.long, device=cuda)
    ko, _ = K.ev_segment(p, days, T, actions=acts, matvecs=run)
    ro, _ = K.ev_segment_ref(p, days, T, actions=acts)
    torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
    d = (ko[..., 0] - ro[..., 0]).abs().cpu().numpy()
    assert np.quantile(d, 0.99) < 1e-4 and d.mean() < 1e-4
    steps = T * days.shape[0]
    if project:
        assert 2 * steps < int(run) <= steps * (2 * int(p.proj.iters) + 2)
    else:
        assert int(run) == steps


@pytest.mark.parametrize("site,batch", [("caltech", 64), ("jpl", 37)])
def test_ev_segment_admm_kernel_matches_plain(cuda, site, batch):
    """The ADMM kernel (30 iterations, four envs a warp) against its
    plain version with the JAX ADMM kernel test's bounds, on prescribed
    actions, in RNG mode and on near-full rates; it runs every iteration:
    C x first, C' y (unless y is 0) and C x in each, the reward's C p."""
    env, p = make("evcharging", site=site, proj_method="admm", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    days = torch.randint(p.n_days, (batch,), generator=g, device=cuda)
    T, iters = 288, int(p.proj.iters)
    for acts in (torch.rand((T, batch, p.n_stations), generator=g,
                            device=cuda),
                 0.8 + 0.2 * torch.rand((T, batch, p.n_stations),
                                        generator=g, device=cuda)):
        before = K.ev_segment.launches
        run = torch.zeros((), dtype=torch.long, device=cuda)
        ko, _ = K.ev_segment(p, days, T, actions=acts, matvecs=run)
        torch.cuda.synchronize()
        assert K.ev_segment.launches == before + 1
        ro, _ = K.ev_segment_ref(p, days, T, actions=acts)
        torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
        d = (ko[..., 0] - ro[..., 0]).abs().cpu().numpy()
        assert np.quantile(d, 0.99) < 1e-4 and d.mean() < 1e-4
        full = batch * T * (2 * iters + 2)
        assert batch * T * (iters + 2) <= int(run) <= full
    ko, a = K.ev_segment(p, days, T, seed=5, record_actions=True)
    ro, _ = K.ev_segment_ref(p, days, T, actions=a)
    torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
    roll = env.fused_rollout(p, batch, T, days=days, actions=a)
    torch.testing.assert_close(roll.reward, ko[..., 0], rtol=0, atol=0)


@pytest.mark.parametrize("site", ["caltech", "jpl"])
@pytest.mark.parametrize("batch", [1, "E8+3", 37])
def test_ev_segment_admm_kernel_ragged_batches(cuda, site, batch):
    """The ADMM kernel steps several envs a warp (E, from its occupancy
    query): batches that fill no CTA of it, at both sites' instances
    (caltech 16 cone rows, jpl 24), against the plain version with the
    bounds above, on prescribed actions and in RNG mode, with the mat-vec
    count inside its bounds."""
    _, p = make("evcharging", site=site, proj_method="admm", device=cuda)
    occ = K.ev_segment_occupancy(int(p.proj.C.shape[0]), admm=True)
    per_cta = occ["warps"] * occ["envs_per_warp"]
    if batch == "E8+3":
        batch = occ["envs_per_warp"] * 8 + 3
    assert batch % per_cta != 0
    g = torch.Generator(device=cuda).manual_seed(2)
    days = torch.randint(p.n_days, (batch,), generator=g, device=cuda)
    T, iters = 288, int(p.proj.iters)
    acts = torch.rand((T, batch, p.n_stations), generator=g, device=cuda)
    run = torch.zeros((), dtype=torch.long, device=cuda)
    ko, _ = K.ev_segment(p, days, T, actions=acts, matvecs=run)
    ro, _ = K.ev_segment_ref(p, days, T, actions=acts)
    torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
    d = (ko[..., 0] - ro[..., 0]).abs().cpu().numpy()
    assert np.quantile(d, 0.99) < 1e-4 and d.mean() < 1e-4
    assert batch * T * (iters + 2) <= int(run) <= batch * T * (2 * iters + 2)
    ko, a = K.ev_segment(p, days, T, seed=6, record_actions=True)
    ro, _ = K.ev_segment_ref(p, days, T, actions=a)
    torch.testing.assert_close(ko[:12], ro[:12], rtol=2e-4, atol=2e-5)
    assert bool(torch.isfinite(ko).all())


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_ev_segment_admm_launch_geometry(cuda, site):
    """Each env's rows do not depend on the envs launched beside it: a
    launch of the first k of B envs gives env e's rows of the launch of all
    B bit for bit, with in-kernel draws (counted by env) and on prescribed
    actions, and the mat-vecs add up env by env."""
    _, p = make("evcharging", site=site, proj_method="admm", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    B, T = 100, 288
    days = torch.randint(p.n_days, (B,), generator=g, device=cuda)
    acts = torch.rand((T, B, p.n_stations), generator=g, device=cuda)
    full, full_a = K.ev_segment(p, days, T, seed=9, record_actions=True)
    full_p, _ = K.ev_segment(p, days, T, actions=acts)
    for k in (1, 5, 17, 64):
        part, part_a = K.ev_segment(p, days[:k], T, seed=9, record_actions=True)
        assert torch.equal(part, full[:, :k]) and torch.equal(part_a, full_a[:, :k])
        part, _ = K.ev_segment(p, days[:k], T, actions=acts[:, :k].contiguous())
        assert torch.equal(part, full_p[:, :k])
    runs = []
    for lo, hi in ((0, 37), (37, B), (0, B)):
        run = torch.zeros((), dtype=torch.long, device=cuda)
        K.ev_segment(p, days[lo:hi], T, actions=acts[:, lo:hi].contiguous(),
                     matvecs=run)
        runs.append(int(run))
    assert runs[0] + runs[1] == runs[2]


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
    16-env policy tiles; then a policy batch of 1029 envs (64 tiles and
    five envs) with the bounds of chip_smoke.check_policy."""
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
    days = torch.randint(p.n_days, (16 * 64 + 5,), generator=g, device=cuda)
    noise = torch.randn((T, days.shape[0], n), generator=g, device=cuda)
    chip_smoke.check_policy(
        "jpl 1029 envs", n, 2 + 2 * n + k,
        K.ev_policy_segment(p, w, days, T, noise=noise),
        K.ev_policy_segment_ref(p, w, days, T, noise=noise), "")


def test_kernel_wrappers_validate_inputs(cuda, tmp_path):
    """The EV wrapper's range checks; building_policy_segment's launcher
    refuses an actor whose activation tiles exceed shared memory, and its
    test entry point a plan it cannot hold (3 tiles, more resident steps
    than a weight has)."""
    _, p, days, _ = _setup(cuda, "caltech", True)
    with pytest.raises(ValueError):
        K.ev_segment(p, days.int(), 12)
    with pytest.raises(ValueError):
        K.ev_segment(p, days, 12,
                     actions=torch.zeros((12, 3, 54), device=cuda))
    with pytest.raises(ValueError):
        K.ev_segment(p, days + p.n_days, 12)
    _, p = _building(cuda, tmp_path)
    n, T = p.n, 8
    epochs = torch.zeros(16, dtype=torch.long, device=cuda)
    big = K.pack_policy_weights(init_policy(
        n + 4, n, 4096, torch.Generator().manual_seed(0), cuda))
    with pytest.raises(RuntimeError):
        K5.building_policy_segment(p, big, epochs, T)
    with pytest.raises(RuntimeError):
        K5.building_policy_plan(n, 4096)
    w = K.pack_policy_weights(init_policy(
        n + 4, n, 64, torch.Generator().manual_seed(1), cuda))
    lib = K5.bind("building_rollout", K5._SIGNATURES)
    out = torch.empty((T, 16, 3), device=cuda)
    lrn = torch.empty((T, 16, 2 * n + 4), dtype=torch.bfloat16, device=cuda)
    m = K5._operator(p)           # held: the launches read it by address
    args = (K5._env_args(p, m, epochs, T, "building_policy_segment")
            + K.policy_weight_args(w) + [64])
    tail = [None, 0, 0, out.data_ptr(), lrn.data_ptr(),
            torch.cuda.current_stream().cuda_stream]
    assert lib.building_policy_segment_launch_plan(*args, 4, 1, 1, 4, 4,
                                                   *tail) == 0
    for plan in ((3, 1, 1, 4, 4), (4, 1, 2, 4, 4), (4, 1, 1, 5, 4),
                 (4, 2, 1, 4, 4)):
        assert lib.building_policy_segment_launch_plan(*args, *plan,
                                                       *tail) != 0
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("batch", [300, 37])
def test_dc_segment_kernel_bit_equal(cuda, batch):
    """Prescribed VCCs (some outside [0, 1], which both clip), then RNG mode
    with the plain version replaying the kernel's VCC row: every row bit
    for bit, over a whole 672-hour episode; a batch of 37 fills no CTA."""
    _, p = make("datacenter", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    T = 672
    months = torch.randint(p.n_months, (batch,), generator=g, device=cuda)
    acts = torch.rand((T, batch), generator=g, device=cuda) * 1.2 - 0.1
    before = K8.dc_segment.launches
    ko = K8.dc_segment(p, months, T, actions=acts)
    torch.cuda.synchronize()
    assert K8.dc_segment.launches == before + 1
    assert torch.equal(ko, K8.dc_segment_ref(p, months, T, actions=acts))
    ko = K8.dc_segment(p, months, T, seed=5)
    a = ko[0].contiguous()
    assert torch.equal(ko, K8.dc_segment_ref(p, months, T, actions=a))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    with pytest.raises(ValueError):
        K8.dc_segment(p, months + p.n_months, T)


def test_dc_fused_rollout_on_card(cuda):
    """The simulation tier launches the gather and the episode kernel once
    per episode; across the boundary the obs splice in the next reset."""
    env, p = make("datacenter", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    counts = (KA.episode_slice_gather.launches, K8.dc_segment.launches)
    roll = env.fused_rollout(p, 512, 674, generator=g)
    assert (KA.episode_slice_gather.launches - counts[0],
            K8.dc_segment.launches - counts[1]) == (2, 2)
    assert roll.reward.shape == (674, 512) and roll.obs.shape == (674, 512, 27)
    assert bool(torch.isfinite(roll.reward).all())
    assert bool(roll.terminated[671].all()) and not roll.terminated[672:].any()


def _market_problem(p, batch, seed):
    """Problem data and warm starts drawn as tests/test_ops_pallas.py
    draws them."""
    rng = np.random.default_rng(seed)
    n, me, ms = p.op.n, p.op.me, p.op.ms

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=p.device)

    return (t(rng.uniform(-50, 50, (batch, n))),
            t(rng.uniform(100, 2000, (batch, me))),
            t(rng.uniform(10, 500, (batch, ms))),
            t(rng.uniform(10, 500, (batch, ms))),
            t(rng.uniform(0, 1, (batch, n))), t(rng.normal(0, 5, (batch, me))),
            t(np.abs(rng.normal(0, 1, (batch, ms)))),
            t(np.abs(rng.normal(0, 1, (batch, ms)))))


@pytest.mark.parametrize("batch,per_env_ub", [(64, False), (37, True),
                                               (4096 + 5, False)])
def test_pdhg_solve_paired_kernel_matches_plain(cuda, batch, per_env_ub):
    """50 warm-started iterations on the SCED operators of horizons 4 (n =
    140, me = 4, ms = 156), 2 (70, 2, 78) and 6 (210, 6, 234: the kernel's
    16-env instance), none a multiple of the kernel's 16-row tiles,
    against the plain version with the JAX package's
    bound for its kernel against its solver (rtol 1e-4 / atol 2e-3,
    tests/test_ops_pallas.py:512-517) on all but 1% of each output's
    entries, and max |d| within 1% of the output's largest value: the
    kernel sums its float32 products in another order than the plain
    version's matmul, which can flip the bf16 rounding of an iterate (one
    bf16 step is 0.4%) that later iterations carry on. 37 and 4101 envs
    fill no 32-env CTA. At horizons 2 and 6 and at 4101 envs the gate is
    chip_smoke.check_solve's, each bound also at twice the plain version's
    own float32-vs-float64 sensitivity: at horizon 2 and 64 envs the plain
    version against itself summing in float64 already has 0.8% of y
    outside the elementwise bound (one env's prices). A shared or per-env
    ub; zero iterations return the clipped start."""
    for horizon in (4, 2, 6):
        _, p = make("electricitymarket", horizon=horizon, device=cuda)
        kops = K9.pack_pdhg_operands(p.op)
        c, b, hp, hm, x0, y0, zp0, zm0 = _market_problem(p, batch, 0)
        ub = p.ub.expand(batch, -1).contiguous() if per_env_ub else p.ub
        args = (c, b, hp, hm, ub, x0, y0, zp0, zm0)
        before = K9.pdhg_solve_paired.launches
        got = K9.pdhg_solve_paired(kops, *args, 50)
        torch.cuda.synchronize()
        assert K9.pdhg_solve_paired.launches == before + 1
        if horizon != 4 or batch > 64:
            chip_smoke.check_solve(f"horizon {horizon} B={batch}", kops, args,
                                   50, "")
        else:
            want = K9.pdhg_solve_paired_ref(kops, *args, 50)
            for k, r in zip(got, want):
                d = (k - r).abs()
                share = float((d > 2e-3 + 1e-4 * r.abs()).float().mean())
                assert share <= 0.01
                assert float(d.max()) <= 0.01 * float(r.abs().max())
        x, y, zp, zm = K9.pdhg_solve_paired(kops, c, b, -hp, hm, ub, x0, -y0,
                                            -zp0, zm0, 0)
        assert torch.equal(x, torch.minimum(x0, ub)) and torch.equal(y, -y0)
        assert torch.equal(zp, torch.zeros_like(zp)) and torch.equal(zm, zm0)


@pytest.mark.parametrize("horizon,batch", [(4, 64), (4, 37), (6, 45)])
def test_pdhg_solve_paired_per_env_budgets_bit_equal(cuda, horizon, batch):
    """(B,) int32 budgets, mixed within each CTA (the 32-env instance at
    horizon 4, the 16-env one at horizon 6; 37 and 45 envs leave a ragged
    last CTA): one launch, and each env bit-equal to a launch with one
    int budget, its own (negative budgets run 0 iterations). The wrapper
    refuses budgets of another dtype or shape."""
    _, p = make("electricitymarket", horizon=horizon, device=cuda)
    c, b, hp, hm, x0, y0, zp0, zm0 = _market_problem(p, batch, 1)
    args = (c, b, hp, hm, p.ub, x0, y0, zp0, zm0)
    rng = np.random.default_rng(2)
    budget = torch.as_tensor(rng.choice([50, 20, 7, 0, -3], batch),
                             dtype=torch.int32, device=cuda)
    before = K9.pdhg_solve_paired.launches
    got = K9.pdhg_solve_paired(p.kops, *args, budget)
    assert K9.pdhg_solve_paired.launches == before + 1
    own = budget.clamp_min(0)
    for k in (50, 20, 7, 0):
        rows = own == k
        assert bool(rows.any())
        uniform = K9.pdhg_solve_paired(p.kops, *args, k)
        for g, u in zip(got, uniform):
            assert torch.equal(g[rows], u[rows]), k
    for bad in (budget.long(), budget[:-1].contiguous()):
        with pytest.raises(ValueError):
            K9.pdhg_solve_paired(p.kops, *args, bad)


def test_captured_generic_market_step_matches_eager(cuda):
    """The market's generic step with autoreset (``capturable_autoreset_
    step``, the off-policy and generic PPO rollouts' step) solves through
    ``pdhg_solve_paired`` with per-env budgets, one launch a step: envs
    at their first step (cold budget) and later ones (warm) in one batch,
    six steps captured in a CUDA graph against the same steps eager from
    the same state and generator: bit-equal."""
    from sustaingym_tpu_torch.core import (capturable_autoreset_step,
                                           tree_select)
    from sustaingym_tpu_torch.core.graph import Graphs, tree_leaves
    env, p = make("electricitymarket", device=cuda)
    assert p.kops is not None
    B, T = 64, 6
    step = capturable_autoreset_step(env)
    space = env.action_space(p)
    g0 = torch.Generator(device=cuda).manual_seed(9)
    fresh, _ = env.reset(p, g0, B)
    later, _ = step(p, fresh, space.sample_batch(g0, B), g0)
    state = tree_select(torch.arange(B, device=cuda) % 2 == 0, fresh, later)
    assert set(state.t.tolist()) == {0, 1}

    def run(state):
        out = []
        for _ in range(T):
            state, ts = step(p, state, space.sample_batch(gen, B), gen)
            out.append(ts.reward)
        return state, torch.stack(out)

    gen = torch.Generator(device=cuda).manual_seed(10)
    before = K9.pdhg_solve_paired.launches
    eager = run(state)
    assert K9.pdhg_solve_paired.launches == before + T
    gen = torch.Generator(device=cuda).manual_seed(10)
    captured = Graphs(cuda)("market steps", run, state, generators=(gen,))
    assert K9.pdhg_solve_paired.launches == before + 3 * T
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(captured),
                                                 tree_leaves(eager)))


def test_market_batch_unroll_on_card(cuda):
    """The card's default market (bf16 products) solves every lockstep
    step with one kernel launch; across the episode boundary the obs
    splice in the next reset."""
    env, p = make("electricitymarket", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    before = K9.pdhg_solve_paired.launches
    roll = env.batch_unroll(p, random_policy(env, p, 64), None, 64, 290, g)
    assert K9.pdhg_solve_paired.launches - before == 290
    assert roll.reward.shape == (290, 64)
    assert bool(torch.isfinite(roll.reward).all())
    assert bool(roll.terminated[287].all())
    assert bool(roll.obs["time"][287].eq(0).all())


def _building(dev, tmp_path, **kw):
    """BuildingEnv on the synthetic tables of envs/building/synthetic.py
    (6 zones)."""
    htm, epw = synthetic.write_building_tables(str(tmp_path))
    return tb.make_env(htm, epw, "Tucson", device=dev, root=str(tmp_path),
                       u_wall=tb.BUILDINGS["OfficeSmall"][1], **kw)


@pytest.mark.parametrize("batch", [300, 37])
def test_building_segment_kernel_bit_equal(cuda, tmp_path, batch):
    """Prescribed actions, then RNG mode with the plain version replaying
    the kernel's recorded actions: every TimeStep field bit for bit over a
    whole 288-step episode, from epochs up to T - 2 (the padded rows); a
    batch of 37 fills no CTA."""
    _, p = _building(cuda, tmp_path)
    g = torch.Generator(device=cuda).manual_seed(6)
    T, n = 288, p.n
    epochs = torch.randint(p.length_of_weather - 1, (batch,), generator=g,
                           device=cuda)
    epochs[0] = p.length_of_weather - 2
    acts = (torch.rand((T, batch, n), generator=g, device=cuda) * 2 - 1
            ) * p.ac_map
    before = K5.building_segment.launches
    ko = K5.building_segment(p, epochs, T, actions=acts)
    torch.cuda.synchronize()
    assert K5.building_segment.launches == before + 1
    ro = K5.building_segment_ref(p, epochs, T, actions=acts)
    for k in ("obs", "zone_temperature", "reward", "comfort_level",
              "power_consumption"):
        assert torch.equal(ko[k], ro[k]), k
    ko = K5.building_segment(p, epochs, T, seed=7, record_actions=True)
    a = ko["actions"]
    ro = K5.building_segment_ref(p, epochs, T, actions=a)
    for k in ("obs", "zone_temperature", "reward", "comfort_level",
              "power_consumption"):
        assert torch.equal(ko[k], ro[k]), k
    r = a / p.ac_map
    assert -1.0 <= float(r.min()) and float(r.max()) < 1.0
    with pytest.raises(ValueError):
        K5.building_segment(p, epochs + p.length_of_weather, T)


def test_building_policy_segment_kernel_matches_plain(cuda, tmp_path):
    """Prescribed noise at H = 64 over a whole episode, with the JAX
    package's bounds for its policy kernel (tests/test_ops_pallas.py:
    461-478): per entry over the first 32 steps, reward statistics over the
    episode."""
    from sustaingym_tpu_torch.parallel import init_policy
    _, p = _building(cuda, tmp_path)
    g = torch.Generator(device=cuda).manual_seed(8)
    B, T, n, H = 300, 288, p.n, 64
    w = K.pack_policy_weights(init_policy(n + 4, n, H, g, cuda))
    epochs = torch.randint(p.length_of_weather - 1, (B,), generator=g,
                           device=cuda)
    noise = torch.randn((T, B, n), generator=g, device=cuda)
    before = K5.building_policy_segment.launches
    ko, kl = K5.building_policy_segment(p, w, epochs, T, noise=noise)
    torch.cuda.synchronize()
    assert K5.building_policy_segment.launches == before + 1
    ro, rl = K5.building_policy_segment_ref(p, w, epochs, T, noise=noise)
    kl, rl = kl.float(), rl.float()
    assert torch.equal(kl[0, :, :n + 4], rl[0, :, :n + 4])   # the reset obs
    for lo, hi in ((0, n), (n + 4, 2 * n + 4)):  # temps, u
        d = (kl[:32, :, lo:hi] - rl[:32, :, lo:hi]).abs().cpu().numpy()
        assert np.quantile(d, 0.99) < 0.05
    dr = (ko[:32, :, 0] - ro[:32, :, 0]).abs().cpu().numpy()
    assert np.quantile(dr, 0.99) < 0.02
    assert abs(float(ko[..., 0].mean() - ro[..., 0].mean())) < 5e-3
    assert abs(float(ko[..., 0].std() - ro[..., 0].std())) < 2e-2


@pytest.mark.parametrize("H", [64, 256, 384])
@pytest.mark.parametrize("n", [1, 6, 8])
def test_building_policy_plan(cuda, n, H):
    """The launcher's shared-memory plan: 64 envs a CTA; b1, b2 and every
    k16 step of w1 and wm resident; w2 whole up to H = 256, and at H = 384
    (w2 alone 288 KB) as many leading steps as fit, one more step of its
    column pairs overflowing what a CTA may hold; one CTA per SM."""
    limit = getattr(torch.cuda.get_device_properties(cuda),
                    "shared_memory_per_block_optin", 232448)   # H100: 227 KB
    plan = K5.building_policy_plan(n, H)
    pairs, kc1, kc2 = -(-H // 16), -(-(n + 4) // 16), -(-H // 16)
    assert (plan["tiles"], plan["bias"], plan["k1"], plan["k3"],
            plan["ctas"]) == (4, 1, kc1, kc2, 1)
    assert plan["smem"] <= limit
    if H <= 256:
        assert plan["k2"] == kc2
    else:
        assert 0 < plan["k2"] < kc2 and plan["smem"] + 512 * pairs > limit


@pytest.mark.parametrize("batch,H", [(16 * 64 + 5, 64), (300, 384)])
def test_building_policy_segment_kernel_tiles(cuda, tmp_path, batch, H):
    """A batch that fills no 64-env CTA (1029 envs: 16 CTAs and five
    envs), and H = 384, whose weights exceed the shared memory beside the
    activation tiles (w2's leading k16 steps resident, the rest read from
    L2), each against the plain version with chip_smoke's bounds (the JAX
    package's for its kernel)."""
    _, p = _building(cuda, tmp_path)
    g = torch.Generator(device=cuda).manual_seed(10)
    T, n = 288, p.n
    plan = K5.building_policy_plan(n, H)
    assert plan["tiles"] == 4 and (plan["k2"] < H // 16) == (H > 256)
    w = K.pack_policy_weights(init_policy(n + 4, n, H, g, cuda))
    epochs = torch.randint(p.length_of_weather - 1, (batch,), generator=g,
                           device=cuda)
    noise = torch.randn((T, batch, n), generator=g, device=cuda)
    before = K5.building_policy_segment.launches
    kernel = K5.building_policy_segment(p, w, epochs, T, noise=noise)
    torch.cuda.synchronize()
    assert K5.building_policy_segment.launches == before + 1
    plain = K5.building_policy_segment_ref(p, w, epochs, T, noise=noise)
    assert torch.equal(kernel[1][0, :, :n + 4], plain[1][0, :, :n + 4])
    chip_smoke.check_building_policy(f"{batch} envs H={H}", n, kernel, plain,
                                     "")


@pytest.mark.parametrize("H,tiles", [(384, 4), (1024, 2), (2048, 1)])
def test_building_policy_segment_plans_bit_equal(cuda, tmp_path, H, tiles):
    """Where the actor sits changes no bit: the launcher's plan (64, 32 or
    16 envs a CTA, weights partly resident) against 16- and (where they
    fit) 32-env CTAs reading every weight and bias from global memory,
    launched through the test entry point on the same prescribed noise."""
    _, p = _building(cuda, tmp_path)
    g = torch.Generator(device=cuda).manual_seed(11)
    B, T, n = 150, 96, p.n
    assert K5.building_policy_plan(n, H)["tiles"] == tiles
    w = K.pack_policy_weights(init_policy(n + 4, n, H, g, cuda))
    epochs = torch.randint(p.length_of_weather - T, (B,), generator=g,
                           device=cuda)
    noise = torch.randn((T, B, n), generator=g, device=cuda)
    want = K5.building_policy_segment(p, w, epochs, T, noise=noise)
    lib = K5.bind("building_rollout", K5._SIGNATURES)
    m = K5._operator(p)           # held: the launches read it by address
    args = (K5._env_args(p, m, epochs, T, "building_policy_segment")
            + K.policy_weight_args(w) + [H])
    for plan in ((1, 0, 0, 0, 0), (2, 0, 0, 0, 0)):
        if plan[0] > tiles:       # the activation tiles alone overflow
            continue
        out = torch.empty_like(want[0])
        lrn = torch.empty_like(want[1])
        assert lib.building_policy_segment_launch_plan(
            *args, *plan, noise.data_ptr(), 0, 0, out.data_ptr(),
            lrn.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want[0]) and torch.equal(lrn, want[1]), plan


def test_building_fused_paths_on_card(cuda, tmp_path):
    """The simulation tier launches the episode kernel once per episode
    (the obs splice in the next reset at the boundary); PPO with bf16 obs
    launches the policy kernel, with float32 obs the slice gather; lr=0
    keeps every ratio at 1."""
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    env, p = _building(cuda, tmp_path)
    g = torch.Generator(device=cuda).manual_seed(9)
    before = K5.building_segment.launches
    roll = env.fused_rollout(p, 512, 290, generator=g)
    assert K5.building_segment.launches - before == 2
    assert roll.obs.shape == (290, 512, p.n + 4)
    assert bool(torch.isfinite(roll.reward).all())
    assert bool(roll.terminated[287].all()) and not roll.terminated[288:].any()
    assert torch.equal(roll.obs[287, :, :p.n], p.target.expand(512, p.n))
    for obs_bf16, kernel in ((True, K5.building_policy_segment),
                             (False, KA.episode_slice_gather)):
        cfg = PPOConfig(num_envs=256, hidden=64, minibatches=4, epochs=1,
                        lr=0.0, obs_bf16=obs_bf16)
        init_state, train_step = make_train_step(env, p, cfg)
        before = kernel.launches
        _, m = train_step(init_state(g), g)
        assert kernel.launches - before == 1
        assert abs(float(m["pg_loss"])) < 1e-5


@pytest.mark.parametrize("name,kwargs,cfg_kwargs", [
    ("evcharging", {}, dict(obs_bf16=True)),
    ("cogen", {}, dict(reward_scale=1e-4)),
    ("electricitymarket", {}, {}),
    ("electricitymarket", {"discrete": True}, dict(algo="a2c")),
    ("evcharging", {"proj_method": "admm"}, {}),
    ("evcharging", {}, dict(rollout_len=64)),
])
def test_captured_train_step_matches_eager(cuda, name, kwargs, cfg_kwargs):
    """Two train steps as CUDA graphs (the fused EV rollout's scoring and
    update; the episode loop of cogen, the market (with its
    pdhg_solve_paired launches) and EV with float32 obs too; the generic
    rollout's steps, its envs carried from the first step into the
    second) against the same steps eager, from the same carry and
    generator state: parameters, metrics and the generator's state
    bit-equal."""
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    env, p = make(name, device=cuda, **kwargs)
    cfg = PPOConfig(num_envs=64, hidden=64, minibatches=4, epochs=2,
                    **cfg_kwargs)
    runs = []
    for capture in (True, False):
        init_state, step = make_train_step(env, p, cfg, capture=capture)
        gen = torch.Generator(device=cuda).manual_seed(4)
        carry = init_state(gen)
        for _ in range(2):
            carry, metrics = step(carry, gen)
        runs.append(([w.detach().clone()
                      for w in carry["policy"].parameters()],
                     {k: float(v) for k, v in metrics.items()},
                     gen.get_state()))
        assert (step.graphs is not None) == capture
        assert step.path == ("generic" if "rollout_len" in cfg_kwargs
                             else "fused" if cfg.obs_bf16 else "episodic")
    (pc, mc, gc), (pe, me, ge) = runs
    assert mc == me
    assert all(torch.equal(a, b) for a, b in zip(pc, pe))
    assert torch.equal(gc, ge)


@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])
def test_captured_adam_matches_optax_float64(cuda, grad_scale):
    """The captured update's optimizer, capturable Adam after the global-
    norm clip, replayed through three updates of prescribed gradients,
    against optax's clip_by_global_norm + adam computed in float64 with
    numpy: the clip active (norm >> 0.5) and inactive."""
    from sustaingym_tpu_torch.core.graph import Graphs
    from sustaingym_tpu_torch.parallel import PPOConfig
    from sustaingym_tpu_torch.parallel import ppo as tppo
    policy = init_policy(12, 3, 16,
                         torch.Generator(device=cuda).manual_seed(0), cuda)
    params = list(policy.parameters())
    opt = tppo._adam(params, PPOConfig(lr=3e-4), cuda)
    rng = np.random.default_rng(1)
    grads = [[rng.normal(0, 1, tuple(w.shape)) * grad_scale for w in params]
             for _ in range(3)]
    for w in params:
        w.grad = torch.zeros_like(w)

    def body(g):
        for w, gi in zip(params, g):
            w.grad.copy_(gi)
        tppo.clip_by_global_norm(params, 0.5)
        opt.step()

    graphs = Graphs(cuda)
    state = params + tppo._adam_state(opt)
    want = [w.detach().double().cpu().numpy() for w in params]
    m = [np.zeros_like(x) for x in want]
    v = [np.zeros_like(x) for x in want]
    for t, g in enumerate(grads, 1):
        graphs("adam", body, [torch.as_tensor(x, dtype=torch.float32,
                                              device=cuda) for x in g],
               state=state)
        g32 = [np.float32(x).astype(np.float64) for x in g]
        norm = np.sqrt(sum(np.sum(x * x) for x in g32))
        if norm >= 0.5:
            g32 = [x / norm * 0.5 for x in g32]
        for i, x in enumerate(g32):
            m[i] = 0.9 * m[i] + 0.1 * x
            v[i] = 0.999 * v[i] + 0.001 * x * x
            want[i] = want[i] - 3e-4 * (m[i] / (1 - 0.9 ** t)) / (
                np.sqrt(v[i] / (1 - 0.999 ** t)) + 1e-8)
    assert graphs.captures == 1
    for w, x in zip(params, want):
        np.testing.assert_allclose(w.detach().double().cpu().numpy(), x,
                                   rtol=0, atol=1e-6)


def test_captured_trainer_save_restore(cuda, tmp_path):
    """A captured cogen trainer saved after one step and restored into a
    fresh trainer (before its first step, which captures) takes the same
    second step as the trainer that ran on: bit-equal parameters."""
    from sustaingym_tpu_torch import train
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    env, p = make("cogen", device=cuda)
    cfg = PPOConfig(num_envs=64, hidden=64, minibatches=4, epochs=2,
                    reward_scale=1e-4)
    init_state, step = make_train_step(env, p, cfg)
    gen = torch.Generator(device=cuda).manual_seed(2)
    carry = init_state(gen)
    carry, _ = step(carry, gen)
    train.save_checkpoint(str(tmp_path), carry, gen, 1)
    carry, _ = step(carry, gen)
    init2, step2 = make_train_step(env, p, cfg)
    gen2 = torch.Generator(device=cuda).manual_seed(99)
    carry2 = init2(gen2)
    assert train.restore_checkpoint(str(tmp_path), carry2, gen2) == 1
    carry2, _ = step2(carry2, gen2)
    for a, b in zip(carry["policy"].parameters(),
                    carry2["policy"].parameters()):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen2.get_state())


def test_graphs_count_replayed_launches_and_hold_one_capture_a_slot(cuda):
    """A registered wrapper's count holds the warm-up's launch and each
    replay's, not the capture's; a slot holds one capture, replaced under
    another key; clear drops them all."""
    from sustaingym_tpu_torch.core import graph
    acc = torch.zeros((), device=cuda)

    @graph.count_launches
    def bump(x):
        acc.add_(x.sum())
        bump.launches += 1
        return x * 2

    try:
        graphs = graph.Graphs(cuda)
        ones = torch.ones(4, device=cuda)
        out = graphs(("a", 1), bump, ones, state=(acc,), repeat=3, slot="s")
        assert bump.launches == 1 + 3 and float(acc) == 12.0
        assert torch.equal(out, 2 * ones)
        graphs(("a", 1), bump, ones, state=(acc,), repeat=2, slot="s")
        assert bump.launches == 6 and float(acc) == 20.0
        assert graphs.captures == 1
        graphs(("a", 2), bump, ones, state=(acc,), slot="s")
        assert graphs.captures == 2 and len(graphs._captured) == 1
        assert bump.launches == 8 and float(acc) == 24.0
        graphs.clear()
        assert not graphs._captured
    finally:
        graph._COUNTED.remove(bump)


def test_market_episode_replay_counts_its_solve_launches(cuda):
    """batch_rollout through a kept Graphs: the first call launches
    pdhg_solve_paired at each step of the warm-up and of the replay, a
    later call once a step (its replay); the captured loop is bit-equal to
    the eager one from the same generator state."""
    from sustaingym_tpu_torch.core import batch_rollout, tree_map
    from sustaingym_tpu_torch.core.graph import Graphs, tree_leaves
    env, p = make("electricitymarket", device=cuda)
    B, T = 64, env.episode_steps(p)
    policy = random_policy(env, p, B)
    eager = batch_rollout(env, p, policy, None,
                          torch.Generator(device=cuda).manual_seed(3), B, T)
    graphs, gen = Graphs(cuda), torch.Generator(device=cuda).manual_seed(3)
    K9.pdhg_solve_paired.launches = 0
    first = tree_map(torch.clone, batch_rollout(env, p, policy, None, gen, B,
                                                T, graphs=graphs))
    assert K9.pdhg_solve_paired.launches == 2 * T
    batch_rollout(env, p, policy, None, gen, B, T, graphs=graphs)
    assert K9.pdhg_solve_paired.launches == 3 * T
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                 tree_leaves(eager)))


@pytest.mark.parametrize("name", ["cogen", "electricitymarket"])
def test_batch_rollout_without_graphs_calls_the_policy_every_step(cuda,
                                                                   name):
    """On the card too, batch_rollout without ``graphs`` is eager: a
    policy that reads the obs on the host and counts its calls sees every
    step."""
    from sustaingym_tpu_torch.core import batch_rollout
    env, p = make(name, device=cuda)
    B, T = 8, env.episode_steps(p) + 2
    draw, seen = random_policy(env, p, B), []

    def policy(_, obs, generator):
        leaves = obs.values() if isinstance(obs, dict) else [obs]
        seen.append(sum(float(x.sum()) for x in leaves))
        return draw(None, obs, generator)

    traj = batch_rollout(env, p, policy, None,
                         torch.Generator(device=cuda).manual_seed(0), B, T)
    assert len(seen) == T and traj.reward.shape == (T, B)


def test_captured_trainer_reinit_drops_its_graphs(cuda):
    """init_state drops the trainer's graphs: a second carry of one
    trainer takes the step a fresh trainer takes from the same seed, and
    the trainer holds one graph per phase (rollout, scoring, update)."""
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    env, p = make("cogen", device=cuda)
    cfg = PPOConfig(num_envs=64, hidden=64, minibatches=4, epochs=2,
                    reward_scale=1e-4)
    runs = []
    for reinit in (True, False):
        init_state, step = make_train_step(env, p, cfg)
        if reinit:
            gen = torch.Generator(device=cuda).manual_seed(8)
            step(init_state(gen), gen)
        gen = torch.Generator(device=cuda).manual_seed(5)
        carry, metrics = step(init_state(gen), gen)
        assert len(step.graphs._captured) == 3
        runs.append(([w.detach().clone()
                      for w in carry["policy"].parameters()],
                     {k: float(v) for k, v in metrics.items()}))
    (pa, ma), (pb, mb) = runs
    assert ma == mb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_evaluation_graph_sees_updated_weights(cuda):
    """train.make_evaluator keeps one Graphs: the second evaluation
    replays the first's captured episode loop, and that graph reads the
    policy's weights in place: after an update it gives what an eager
    evaluation of the updated policy gives (bit-equal), not the old
    return."""
    from sustaingym_tpu_torch import train
    from sustaingym_tpu_torch.core import batch_rollout
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    env, p = make("evcharging", device=cuda)
    cfg = PPOConfig(num_envs=64, hidden=32, minibatches=4, epochs=1,
                    rollout_len=32, lr=3e-3)
    init_state, step = make_train_step(env, p, cfg)
    gen = torch.Generator(device=cuda).manual_seed(6)
    carry = init_state(gen)
    evaluate = train.make_evaluator(env, p, step, episodes=8, seed=0)
    first = evaluate(carry["policy"], 1)
    assert evaluate(carry["policy"], 1) == first
    carry, _ = step(carry, gen)
    with torch.no_grad():
        carry["policy"].mu.bias.add_(0.5)
    after = evaluate(carry["policy"], 1)
    assert evaluate.graphs.captures == 1
    assert after["mean_return"] != first["mean_return"]
    eager = batch_rollout(
        env, p, lambda w, obs, g: step.actor(w, obs), carry["policy"],
        torch.Generator(device=cuda).manual_seed(500_001), 8,
        env.episode_steps(p))
    assert after["mean_return"] == float(eager.reward.sum(0).mean())


@pytest.mark.parametrize("name", ["cogen", "datacenter", "electricitymarket",
                                  "building"])
def test_generic_rollout_captured_on_every_env(cuda, tmp_path, name):
    """The generic rollout (a length other than the episode's) of every
    other env is captured too: its step and whole-batch reset copy no host
    data (the market's step reads its per-env solve budgets on the card,
    in its one ``pdhg_solve_paired`` launch). Two train steps crossing an episode end, captured against
    eager: bit-equal parameters, metrics and generator state."""
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    if name == "building":
        env, p = _building(cuda, tmp_path)
    else:
        env, p = make(name, device=cuda)
    T = env.episode_steps(p) // 2 + 5
    cfg = PPOConfig(num_envs=32, hidden=32, minibatches=4, epochs=1,
                    rollout_len=T,
                    reward_scale=1e-4 if name == "cogen" else 1.0)
    runs = []
    for capture in (True, False):
        init_state, step = make_train_step(env, p, cfg, capture=capture)
        assert step.path == "generic"
        gen = torch.Generator(device=cuda).manual_seed(7)
        carry = init_state(gen)
        done = 0.0
        for _ in range(2):
            carry, metrics = step(carry, gen)
            done += float(metrics["episode_done_frac"])
        assert done > 0
        runs.append(([w.detach().clone()
                      for w in carry["policy"].parameters()],
                     {k: float(v) for k, v in metrics.items()},
                     gen.get_state()))
    (pc, mc, gc), (pe, me, ge) = runs
    assert mc == me
    assert all(torch.equal(a, b) for a, b in zip(pc, pe))
    assert torch.equal(gc, ge)


def _ma_trainer(dev, tmp_path, case):
    """(env, params, cfg) of each multi-agent trainer at a small size: the
    uniform-obs MA-EV, MA-EV with periods_delay 2 (agent axis, episodic),
    MA cogen (per-agent stacked policies), MA building and discrete MA-EV
    (agent axis, generic)."""
    from sustaingym_tpu_torch.envs.multiagent import MultiAgentBuildingEnv
    from sustaingym_tpu_torch.parallel import PPOConfig
    small = dict(hidden=64, minibatches=4, epochs=2)
    if case == "building":
        _, p = _building(dev, tmp_path)
        return (MultiAgentBuildingEnv(p), p,
                PPOConfig(num_envs=64, rollout_len=32, **small))
    name, kw, cfg = {
        "uma": ("evcharging-multiagent", dict(project_action=False),
                dict(num_envs=16, obs_bf16=True)),
        "delay2": ("evcharging-multiagent",
                   dict(project_action=False, periods_delay=2),
                   dict(num_envs=16, obs_bf16=True)),
        "cogen": ("cogen-multiagent", {},
                  dict(num_envs=64, reward_scale=1e-4)),
        "discrete": ("evcharging-multiagent", dict(discrete_bins=5),
                     dict(num_envs=16, rollout_len=32)),
    }[case]
    env, p = make(name, device=dev, **kw)
    return env, p, PPOConfig(**small, **cfg)


@pytest.mark.parametrize("case", ["uma", "delay2", "cogen", "building",
                                  "discrete"])
def test_captured_ma_train_step_matches_eager(cuda, tmp_path, case):
    """Each multi-agent trainer: two train steps as CUDA graphs against
    the same steps eager from the same carry and generator state
    (parameters, metrics and the generator's state bit-equal), as
    test_captured_train_step_matches_eager holds the single-agent ones."""
    from sustaingym_tpu_torch.parallel import make_train_step
    env, p, cfg = _ma_trainer(cuda, tmp_path, case)
    runs = []
    for capture in (True, False):
        init_state, step = make_train_step(env, p, cfg, capture=capture)
        assert step.uma == (case == "uma")
        assert step.per_agent == (case == "cogen")
        gen = torch.Generator(device=cuda).manual_seed(4)
        carry = init_state(gen)
        for _ in range(2):
            carry, metrics = step(carry, gen)
        runs.append(([w.detach().clone()
                      for w in carry["policy"].parameters()],
                     {k: float(v) for k, v in metrics.items()},
                     gen.get_state()))
        assert (step.graphs is not None) == capture
    (pc, mc, gc), (pe, me, ge) = runs
    assert mc == me
    assert all(np.isfinite(v) for v in mc.values())
    assert all(torch.equal(a, b) for a, b in zip(pc, pe))
    assert torch.equal(gc, ge)


@pytest.mark.parametrize("case", ["delay2", "cogen"])
def test_captured_ma_trainer_reinit_drops_its_graphs(cuda, tmp_path, case):
    """init_state on a multi-agent trainer drops its graphs: a second
    carry takes the step a fresh trainer takes from the same seed, with
    one graph per phase (the generic rollout, MA cogen's, two: its steps
    without and with the reset, which its 96-step rollout reaches)."""
    from sustaingym_tpu_torch.parallel import make_train_step
    env, p, cfg = _ma_trainer(cuda, tmp_path, case)
    runs = []
    for reinit in (True, False):
        init_state, step = make_train_step(env, p, cfg)
        if reinit:
            gen = torch.Generator(device=cuda).manual_seed(8)
            step(init_state(gen), gen)
        gen = torch.Generator(device=cuda).manual_seed(5)
        carry, metrics = step(init_state(gen), gen)
        assert len(step.graphs._captured) == (
            4 if step.path == "generic" else 3)
        runs.append(([w.detach().clone()
                      for w in carry["policy"].parameters()],
                     {k: float(v) for k, v in metrics.items()}))
    (pa, ma), (pb, mb) = runs
    assert ma == mb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


# ---------------------------------------------------------------------------
# the off-policy learners (SAC, DQN, DDPG): no kernel, captured train steps
# ---------------------------------------------------------------------------

OFF_POLICY_CASES = {
    # ring capacity 16 of rollout_len 4: one block write a train step
    "sac ev block": ("evcharging", {"project_action": False}, "sac",
                     dict(capacity=16)),
    # capacity 6: per-step writes, wrapping in the second step
    "sac ev per-step": ("evcharging", {"project_action": False}, "sac",
                        dict(capacity=6, per_env_sample=True)),
    "dqn market": ("electricitymarket", {"discrete": True}, "dqn",
                   dict(capacity=16)),
    "dqn ma-ev per-step": ("evcharging-multiagent",
                           {"discrete_bins": 5, "project_action": False},
                           "dqn", dict(capacity=6, num_envs=16)),
    "ddpg market per-step": ("electricitymarket", {}, "ddpg",
                             dict(capacity=6)),
}


def _off_policy(dev, case, capture=True, **overrides):
    from sustaingym_tpu_torch import parallel as P
    name, kwargs, algo, cfg_kw = OFF_POLICY_CASES[case]
    env, p = make(name, device=dev, **kwargs)
    config, factory = {"sac": (P.SACConfig, P.make_sac_train_step),
                       "dqn": (P.DQNConfig, P.make_dqn_train_step),
                       "ddpg": (P.DDPGConfig, P.make_ddpg_train_step)}[algo]
    kw = dict(num_envs=64, rollout_len=4, batch_per_env=2, updates=3,
              hidden=32)
    kw.update(cfg_kw)
    kw.update(overrides)
    cfg = config(**kw)
    return cfg, factory(env, p, cfg, capture=capture)


def _off_policy_runs(dev, case, steps=2):
    runs = []
    for capture in (True, False):
        cfg, (init_state, step) = _off_policy(dev, case, capture)
        gen = torch.Generator(device=dev).manual_seed(5)
        carry = init_state(gen)
        for _ in range(steps):
            carry, metrics = step(carry, gen)
        assert (step.graphs is not None) == capture
        runs.append(({k: t.detach().clone() for k, t in
                      chip_smoke.carry_tensors(carry).items()},
                     {k: float(v) for k, v in metrics.items()},
                     gen.get_state(), carry))
    return cfg, runs


@pytest.mark.parametrize("case", list(OFF_POLICY_CASES))
def test_captured_off_policy_step_matches_eager(cuda, case):
    """Two off-policy train steps as CUDA graphs (the rollout into the
    ring, each update) against the same steps eager from the same carry
    and generator state: every weight, target, optimizer state and
    log_alpha, the ring, written, DQN's iter, the carried env states and
    obs, the metrics and the generator state bit-equal."""
    _, ((tc, mc, gc, _), (te, me, ge, _)) = _off_policy_runs(cuda, case)
    assert mc == me and all(np.isfinite(v) for v in mc.values())
    assert [k for k in tc if not torch.equal(tc[k], te[k])] == []
    assert torch.equal(gc, ge)


@pytest.mark.parametrize("case", ["sac ev block", "dqn market",
                                  "ddpg market per-step"])
def test_captured_off_policy_lr0_keeps_every_weight(cuda, case):
    """lr=0 (and alpha_lr=0 for SAC): one captured train step leaves every
    online weight and log_alpha bit-equal, with finite losses."""
    extra = {"alpha_lr": 0.0} if case.startswith("sac") else {}
    _, (init_state, step) = _off_policy(cuda, case, lr=0.0, **extra)
    gen = torch.Generator(device=cuda).manual_seed(6)
    carry = init_state(gen)
    before = {k: t.detach().clone()
              for k, t in chip_smoke.online_weights(carry).items()}
    carry, metrics = step(carry, gen)
    after = chip_smoke.online_weights(carry)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("case", ["sac ev block", "sac ev per-step"])
def test_captured_off_policy_ring_holds_the_eager_transitions(cuda, case):
    """After one train step the captured trainer's ring holds the eager
    one's transitions in the same slots (a block write, and per-step
    writes), written == rollout_len, the slots past it still zero, and
    each slot's next_obs is the next slot's obs."""
    cfg, ((_, _, _, cc), (_, _, _, ce)) = _off_policy_runs(cuda, case, 1)
    T = cfg.rollout_len
    assert int(cc["written"]) == int(ce["written"]) == T
    for k in cc["buffer"]:
        assert torch.equal(cc["buffer"][k], ce["buffer"][k]), k
    ring = cc["buffer"]
    assert not ring["obs"][T:].any()
    assert ring["obs"][:T].abs().sum() > 0
    assert torch.equal(ring["next_obs"][:T - 1], ring["obs"][1:T])


@pytest.mark.parametrize("kernel", ["ev", "building"])
def test_policy_kernels_env_offset_slices_bit_equal(cuda, tmp_path, kernel):
    """The policy kernels key their Philox draws by the global env index:
    a launch at ``env_offset`` o over b envs is bit-equal to rows [o,
    o + b) of the launch over all (offsets that split 16-env tiles)."""
    if kernel == "ev":
        _, p, days, _ = _setup(cuda, "caltech", True, 100)
        n, k = p.n_stations, p.moer_forecast_steps
        w = K.pack_policy_weights(init_policy(
            2 + 2 * n + k, n, 64, torch.Generator().manual_seed(0), cuda))

        def launch(o, b):
            return K.ev_policy_segment(p, w, days[o:o + b], 288, seed=11,
                                       env_offset=o)
    else:
        _, p = _building(cuda, tmp_path)
        w = K.pack_policy_weights(init_policy(
            p.n + 4, p.n, 64, torch.Generator().manual_seed(0), cuda))
        days = torch.arange(100, device=cuda) * 3

        def launch(o, b):
            return K5.building_policy_segment(p, w, days[o:o + b], 288,
                                              seed=11, env_offset=o)
    full = launch(0, 100)
    for o, b in ((0, 37), (37, 63), (99, 1)):
        part = launch(o, b)
        for x, y in zip(part, full):
            assert torch.equal(x, y[:, o:o + b]), (o, b)


@pytest.mark.parametrize("m,k,n", [(24576, 146, 256), (24576, 256, 256),
                                   (24576, 256, 55)])
def test_bf16_gemm_float64_gate(cuda, m, k, n):
    """The PPO learner's bf16 products (obs x trunk1, h1 x trunk2, h2 x
    heads at the EV trainer's minibatch rows) as bf16 GEMMs with float32
    output (``ppo_trunk.bf16_matmul``), and the float32 route of the same
    bf16 values, each within 64 * 2^-24 * sum_k |a_k b_k| of the float64
    product. (The trunk's backward products, float32 on float32
    cotangents, are held to the autograd chain they replaced in
    ``tests/test_torch_ppo_trunk.py``.)"""
    from sustaingym_tpu_torch.ops.cuda.ppo_trunk import bf16_matmul
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    w = torch.randn((n, k), generator=g, device=cuda).bfloat16()
    ref = a.double() @ w.double().t()
    bound = 64 * 2.0 ** -24 * (a.double().abs() @ w.double().abs().t())
    for out in (bf16_matmul(a, w), a.float() @ w.float().t()):
        assert out.dtype == torch.float32
        assert bool(((out.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_phase_gated_rollout_captured_matches_eager(cuda, algo):
    """EV generic PPO (projection on) and SAC EV (off), rollout 64: five
    train steps cross the episode end at step 288 (the reset graph's
    first replay in the fifth), captured against eager: bit-equal
    parameters, metrics, env states and generator; the guard reads 0."""
    from sustaingym_tpu_torch import parallel as P
    env, p = make("evcharging", device=cuda, project_action=algo == "ppo")
    if algo == "ppo":
        cfg = P.PPOConfig(num_envs=64, rollout_len=64, hidden=32,
                          minibatches=4, epochs=1)
        factory = P.make_train_step
    else:
        cfg = P.SACConfig(num_envs=64, rollout_len=64, hidden=32, updates=2)
        factory = P.make_sac_train_step
    runs = []
    for capture in (None, False):
        init_state, step = factory(env, p, cfg, capture=capture)
        gen = torch.Generator(device=cuda).manual_seed(2)
        carry = init_state(gen)
        for _ in range(5):
            carry, metrics = step(carry, gen)
        step.check(carry)
        assert int(carry["reset_guard"]) == 0
        assert int(carry["env_phase"]) == 5 * 64 % 288
        runs.append(({k: t.detach().clone() for k, t in
                      chip_smoke.carry_tensors(carry).items()},
                     {k: float(v) for k, v in metrics.items()},
                     gen.get_state()))
    (tc, mc, gc), (te, me, ge) = runs
    assert mc == me
    assert [k for k in tc if not torch.equal(tc[k], te[k])] == []
    assert torch.equal(gc, ge)


def test_two_gloo_ranks_on_the_card(cuda):
    """Two gloo ranks share the card (dp = 2, the EV fused trainer at 256
    global envs, lr = 0): each launches ev_policy_segment on its 128
    envs, their parameters stay bit-equal, and their metrics equal one
    rank's on the same global batch to the reassociation of the sums."""
    from sustaingym_tpu_torch.bench_scaling import rank_run, run_ranks
    cfg = {"num_envs": 256, "rollout_len": None, "hidden": 64,
           "minibatches": 4, "epochs": 1, "obs_bf16": True, "lr": 0.0}
    one = rank_run("evcharging", "ppo", cfg, 1, 1, 0, "cuda", {})
    two = run_ranks(2, "evcharging", "ppo", cfg, steps=1, device="cuda")
    assert one["path"] == two[0]["path"] == "fused"
    assert two[0]["params"] == two[1]["params"] == one["params"]
    for r in two:
        assert r["launches"]["ev_policy_segment"] == 2
        for a, b in zip(one["metrics"], r["metrics"]):
            for key in a:
                assert b[key] == pytest.approx(a[key], rel=1e-3,
                                               abs=1e-5), key


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
@pytest.mark.parametrize("case", ["inside", "beyond", "at_bounds",
                                  "const_adv"])
@pytest.mark.parametrize("rows,act_dim,strided", [(24576, 54, True),
                                                  (24576, 54, False),
                                                  (1001, 7, True),
                                                  (37, 1, True),
                                                  (3001, 118, True),
                                                  (64, 1024, True)])
def test_ppo_loss_kernel_matches_plain_and_float64(cuda, rows, act_dim,
                                                   strided, case, ent_coef):
    """The fused PPO loss head (``ops/cuda/ppo_loss.py``) at the EV
    trainer's minibatch (24576 x 54, ``mu`` a slice of the head product),
    at ragged sizes, at widths beyond a warp's two columns a lane (118)
    and at the kernel's widest (1024), against autograd through
    ``loss_fn`` in float64 (its log(2 pi) as float32 rounds it, as the
    kernel and the scoring take it) and, up to 64 wide, against the plain
    version in float32: every output within 1e-5 of the float64
    reference's scale (a gradient's largest entry; pg, vf and the loss
    the mean of the absolute per-row terms). At the bounds each ratio is
    the float32 bound itself, with the advantage's sign on the side where
    the gradient is continuous (``tests/_ppo_loss_cases.py``)."""
    from sustaingym_tpu_torch.ops.cuda import ppo_loss as KL
    from tests._ppo_loss_cases import args_of, gaps, make_case, reference
    c = make_case(case, rows, act_dim, ent_coef, strided,
                  dtype=torch.float32, exact=False, seed=rows + act_dim)
    want, scale = reference(c)
    args = args_of(c, cuda)
    assert args[0].is_contiguous() != strided
    if case == "at_bounds":
        # the card's expf puts every ratio on a float32 bound exactly
        bounds = torch.tensor([0.8, 1.2], device=cuda)
        assert bool(torch.isin(torch.exp(-args[4]), bounds).all())
    before = KL.ppo_gauss_loss.launches
    got = KL.ppo_gauss_loss(*args)
    assert KL.ppo_gauss_loss.launches - before == 1
    against = [gaps(got, want, scale)]
    if act_dim <= 64:
        # wider, the plain version's own float32 sum of the log-prob is
        # 1e-5 to 7e-5 of the scale off float64 (the kernel's compensated
        # sum is not), so the kernel answers to float64 alone
        plain = KL.ppo_gauss_loss_ref(*args_of(c))
        against.append(gaps(got, {k: v.double() for k, v in
                                  zip(want, plain)}, scale))
    for gap_of in against:
        for name, gap in gap_of.items():
            assert gap < 1e-5, (name, gap)


def test_ppo_loss_kernel_is_bit_reproducible(cuda):
    """Two calls on the same inputs give the same bits (no atomics: the
    captured and eager train steps are compared bit for bit)."""
    from sustaingym_tpu_torch.ops.cuda import ppo_loss as KL
    from tests._ppo_loss_cases import args_of, make_case
    c = make_case("beyond", 24576, 54, 0.01, True, dtype=torch.float32,
                  exact=False)
    args = args_of(c, cuda)
    first = [x.clone() for x in KL.ppo_gauss_loss(*args)]
    second = KL.ppo_gauss_loss(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("case", ["ev", "market_a2c", "ma_cogen"])
def test_fused_loss_launches_per_train_step(cuda, tmp_path, case):
    """Under a trace recording, one captured train step after the first
    launches the fused loss head once a minibatch (epochs x minibatches)
    for the fused EV trainer, and never for a categorical head (the
    discrete market, A2C) or masked per-agent policies (MA cogen)."""
    from sustaingym_tpu_torch.core import trace
    from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
    if case == "ma_cogen":
        env, p, cfg = _ma_trainer(cuda, tmp_path, "cogen")
    elif case == "ev":
        env, p = make("evcharging", device=cuda)
        cfg = PPOConfig(num_envs=64, hidden=64, minibatches=4, epochs=2,
                        obs_bf16=True)
    else:
        env, p = make("electricitymarket", device=cuda, discrete=True)
        cfg = PPOConfig(num_envs=64, hidden=64, minibatches=4, epochs=2,
                        algo="a2c")
    init_state, step = make_train_step(env, p, cfg)
    gen = torch.Generator(device=cuda).manual_seed(5)
    carry = init_state(gen)
    carry, _ = step(carry, gen)
    with trace.recording() as rec:
        carry, _ = step(carry, gen)
    launches = rec.snapshot()["launches"]["ppo_gauss_loss"]
    assert launches == (cfg.epochs * cfg.minibatches if case == "ev" else 0)
