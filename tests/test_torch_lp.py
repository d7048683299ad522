"""PyTorch port of the PDHG LP solver (sustaingym_tpu_torch.ops.lp) and the
plain version of the whole-solve PDHG kernel
(sustaingym_tpu_torch.ops.cuda.lp_solve), against the JAX package's
ops.lp and its Pallas kernel (interpret mode) on the SCED operator, with
problem data made with numpy from a seed.

Tolerances: step sizes rtol 1e-7 (both are the same float64 host
computation rounded to float32); solves rtol 1e-4 / atol 2e-3, the JAX
package's own bound for its kernel against its solver
(tests/test_ops_pallas.py:512-517): 50 iterations of float32 sums in
another order; float64 paired against stacked rtol / atol 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.envs import electricitymarket as jem
from sustaingym_tpu.envs.electricitymarket.network import (
    build_network as jbuild_network, build_sced_matrices as jbuild_sced)
from sustaingym_tpu.ops import lp as jlp
from sustaingym_tpu.ops.pallas.lp_solve import (pack_pdhg_operands as jpack,
                                                pdhg_solve_paired as jpdhg)
from sustaingym_tpu_torch.core import replace
from sustaingym_tpu_torch.envs import electricitymarket as tem
from sustaingym_tpu_torch.ops import lp as tlp
from sustaingym_tpu_torch.ops.cuda import lp_solve as K9

SOLVE = dict(rtol=1e-4, atol=2e-3)


def _sced_ops(bf16: bool):
    mats = jbuild_sced(jbuild_network(), 4)
    G = np.zeros((0, mats["A"].shape[1]))
    kw = dict(iters=50, sym=mats["S"], precond_alpha=0.35)
    jop = jlp.make_lp_operator(mats["A"], G, dtype=jnp.float32,
                               matmul_dtype=jnp.bfloat16 if bf16 else None,
                               **kw)
    top = tlp.make_lp_operator(mats["A"], G,
                               matmul_dtype=torch.bfloat16 if bf16 else None,
                               device="cpu", **kw)
    return jop, top, mats["ub"]


def _problem(op, B, seed=0):
    """Problem data and warm starts drawn as tests/test_ops_pallas.py
    draws them."""
    rng = np.random.default_rng(seed)
    n, me, ms = op.n, op.me, op.ms
    f = np.float32
    return dict(c=rng.uniform(-50, 50, (B, n)).astype(f),
                b=rng.uniform(100, 2000, (B, me)).astype(f),
                h=rng.uniform(10, 500, (B, 2 * ms)).astype(f),
                x0=rng.uniform(0, 1, (B, n)).astype(f),
                y0=rng.normal(0, 5, (B, me)).astype(f),
                z0=np.abs(rng.normal(0, 1, (B, 2 * ms))).astype(f))


def test_make_lp_operator_matches_jax():
    jop, top, _ = _sced_ops(bf16=False)
    assert (top.n, top.me, top.ms, top.mg, top.mi) == (140, 4, 156, 0, 312)
    assert (top.n, top.me, top.ms, top.mg) == (jop.n, jop.me, jop.ms, jop.mg)
    for name in ("A", "S", "tau", "sigma_a", "sigma_s"):
        np.testing.assert_allclose(getattr(top, name).numpy(),
                                   np.asarray(getattr(jop, name)), rtol=1e-7,
                                   atol=0, err_msg=name)
    # a random operator with residual one-sided rows
    rng = np.random.default_rng(3)
    A, S, G = (rng.normal(size=s) for s in ((3, 12), (4, 12), (5, 12)))
    jop = jlp.make_lp_operator(A, G, sym=S, dtype=jnp.float32,
                               precond_alpha=1.3)
    top = tlp.make_lp_operator(A, G, sym=S, precond_alpha=1.3, device="cpu")
    for name in ("tau", "sigma_a", "sigma_s", "sigma_g", "G"):
        np.testing.assert_allclose(getattr(top, name).numpy(),
                                   np.asarray(getattr(jop, name)), rtol=1e-7,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("bf16", [False, True])
def test_solve_lp_matches_jax(bf16):
    """50 warm-started iterations on the SCED operator, float32 and bf16
    products."""
    jop, top, ub = _sced_ops(bf16)
    d = _problem(top, 8)
    B, ms = 8, top.ms
    jsol = jlp.solve_lp(jop, *(jnp.asarray(d[k]) for k in "cbh"),
                        jnp.zeros((B, top.n), jnp.float32),
                        jnp.broadcast_to(jnp.asarray(ub, jnp.float32),
                                         (B, top.n)),
                        init=jlp.LPSolution(*(jnp.asarray(d[k])
                                              for k in ("x0", "y0", "z0"))),
                        iters=50)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tub = torch.as_tensor(ub, dtype=torch.float32)
    tsol = tlp.solve_lp(top, t["c"], t["b"], t["h"], torch.zeros_like(tub),
                        tub, init=tlp.LPSolution(t["x0"], t["y0"], t["z0"]),
                        iters=50)
    for field in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(tsol, field).numpy(),
                                   np.asarray(getattr(jsol, field)), **SOLVE,
                                   err_msg=field)
    assert tsol.z.shape == (B, 2 * ms) and bool((tsol.z >= 0).all())


def test_pdhg_solve_paired_ref_matches_jax_kernel():
    """The plain version of the port's kernel (a CPU tensor runs it)
    against the JAX package's whole-solve Pallas kernel in interpret mode,
    as tests/test_ops_pallas.py runs it against its solver."""
    jop, top, ub = _sced_ops(bf16=True)
    d = _problem(top, 8)
    n, me, ms = top.n, top.me, top.ms
    jub = jnp.broadcast_to(jnp.asarray(ub, jnp.float32), (8, n))
    jx, jy, jzp, jzm = jpdhg(
        jpack(jop), jnp.asarray(d["c"]), jnp.asarray(d["b"]),
        jnp.asarray(d["h"][:, :ms]), jnp.asarray(d["h"][:, ms:]), jub,
        jnp.asarray(d["x0"]), jnp.asarray(d["y0"]),
        jnp.asarray(d["z0"][:, :ms]), jnp.asarray(d["z0"][:, ms:]),
        dims=(n, me, ms), iters=50, w=8, interpret=True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    kops = K9.pack_pdhg_operands(replace(top, matmul_dtype=None))
    assert kops.K.dtype == torch.bfloat16 and kops.K.shape == (me + ms, n)
    launches = K9.pdhg_solve_paired.launches
    x, y, zp, zm = K9.pdhg_solve_paired(
        kops, t["c"], t["b"], t["h"][:, :ms].contiguous(),
        t["h"][:, ms:].contiguous(), torch.as_tensor(ub, dtype=torch.float32),
        t["x0"], t["y0"], t["z0"][:, :ms].contiguous(),
        t["z0"][:, ms:].contiguous(), 50)
    assert K9.pdhg_solve_paired.launches == launches   # CPU: plain version
    for got, want in ((x, jx), (y, jy), (zp, jzp), (zm, jzm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE)
    with pytest.raises(ValueError):
        K9.pack_pdhg_operands(tlp.make_lp_operator(
            np.ones((1, 3)), np.ones((2, 3)), device="cpu"))


@pytest.mark.parametrize("horizon", [4, 2])
def test_pack_pdhg_operands_pads_k_into_mma_tiles(horizon):
    """The kernel's tile-padded operator Kp holds K = [A; S] bit for bit:
    the A rows at the top, the S rows from the next multiple of 16, every
    other entry zero; at horizons 4 (n = 140, me = 4, ms = 156) and 2 (70,
    2, 78) n, me and ms are not multiples of 16."""
    _, p = tem.make_env(horizon=horizon, device="cpu")
    kops = K9.pack_pdhg_operands(p.op)
    n, me, ms = p.op.n, p.op.me, p.op.ms
    assert (n, me, ms) == (35 * horizon, horizon, 39 * horizon)
    me_p, ms_p, n_p = (-(-v // 16) * 16 for v in (me, ms, n))
    Kp = kops.Kp
    assert Kp.dtype == torch.bfloat16 and Kp.shape == (me_p + ms_p, n_p)
    assert torch.equal(Kp[:me, :n], kops.K[:me])
    assert torch.equal(Kp[me_p:me_p + ms, :n], kops.K[me:])
    rest = Kp.clone()
    rest[:me, :n] = 0
    rest[me_p:me_p + ms, :n] = 0
    assert not rest.any()
    assert torch.equal(kops.K, torch.cat([p.op.A, p.op.S]).bfloat16())


def test_per_env_budgets_freeze_each_env():
    """A (B,) iteration budget runs the largest and freezes each env after
    its own: each env of a pair solved with budgets (30, 7) equals the pair
    solved with that env's budget for both, bit for bit; through the
    market's step, an env at its episode's first step (cold budget) and
    one later in its episode (warm budget) stepped together equal each
    stepped alone (rtol 1e-5 / atol 1e-4: a batch of one sums its
    products in another order than a batch of two)."""
    _, top, ub = _sced_ops(bf16=False)
    d = {k: torch.from_numpy(v) for k, v in _problem(top, 2, seed=4).items()}
    tub = torch.as_tensor(ub, dtype=torch.float32)
    lb = torch.zeros_like(tub)

    def solve(iters):
        return tlp.solve_lp(top, d["c"], d["b"], d["h"], lb, tub,
                            init=tlp.LPSolution(d["x0"], d["y0"], d["z0"]),
                            iters=iters)

    both = solve(torch.tensor([30, 7]))
    for i, iters in ((0, 30), (1, 7)):
        alone = solve(iters)
        for field in ("x", "y", "z"):
            assert torch.equal(getattr(both, field)[i],
                               getattr(alone, field)[i]), (i, field)
    assert not torch.equal(both.x[1], solve(30).x[1])

    env, p = tem.make_env(lp_iters=30, lp_warm_iters=10, device="cpu")
    rng = np.random.default_rng(5)
    acts = torch.from_numpy(rng.uniform(0, 200, (4, 2, 8)).astype(np.float32))
    fresh, _ = env.reset_at_day(p, torch.tensor([3]))
    later, _ = env.reset_at_day(p, torch.tensor([9]))
    for t in range(3):
        later, _ = env.step(p, later, acts[t, 1:])
    pair = replace(fresh, **{f: torch.cat([getattr(fresh, f),
                                           getattr(later, f)])
                             for f in fresh.__dataclass_fields__})
    assert pair.t.tolist() == [0, 3]
    _, ts_pair = env.step(p, pair, acts[3])
    for i, st in enumerate((fresh, later)):
        _, ts = env.step(p, st, acts[3, i:i + 1])
        for k in ts.info:
            np.testing.assert_allclose(ts_pair.info[k][i:i + 1].numpy(),
                                       ts.info[k].numpy(), rtol=1e-5,
                                       atol=1e-4, err_msg=k)


def test_pdhg_solve_paired_ref_per_env_budgets():
    """The kernel's plain version with a (B,) int32 budget (what the
    market's generic step gives the kernel on the card) is ``solve_lp``'s
    per-env freeze, bit for bit; each env equals the JAX package's Pallas
    kernel (interpret mode) run at that env's own budget, by the port's
    gate for a kernel against its plain version (``chip_smoke.
    check_solve``): at most 1% of each output's entries outside SOLVE and
    max |d| within 1% of the output's largest value (a float32 sum in
    another order can flip one bf16 rounding, which later iterations
    carry on: here 1 entry of 468); a budget of 0 or below returns the
    clipped warm start."""
    jop, top, ub = _sced_ops(bf16=True)
    B = 8
    d = _problem(top, B, seed=6)
    n, me, ms = top.n, top.me, top.ms
    budget = torch.tensor([50, 20, 0, -3, 50, 20, 7, 50], dtype=torch.int32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    tub = torch.as_tensor(ub, dtype=torch.float32)
    kops = K9.pack_pdhg_operands(top)
    args = (t["c"], t["b"], t["h"][:, :ms].contiguous(),
            t["h"][:, ms:].contiguous(), tub, t["x0"], t["y0"],
            t["z0"][:, :ms].contiguous(), t["z0"][:, ms:].contiguous())
    got = K9.pdhg_solve_paired(kops, *args, budget)
    op = replace(top, relax=1.0, merge_blocks=False)
    sol = tlp.solve_lp(op, t["c"], t["b"], t["h"], torch.zeros_like(tub),
                       tub, init=tlp.LPSolution(t["x0"], t["y0"], t["z0"]),
                       iters=budget.long())
    for g, w in zip(got, (sol.x, sol.y, sol.z[:, :ms], sol.z[:, ms:])):
        assert torch.equal(g, w)
    jub = jnp.broadcast_to(jnp.asarray(ub, jnp.float32), (B, n))
    for k in (50, 20, 7):
        want = jpdhg(
            jpack(jop), jnp.asarray(d["c"]), jnp.asarray(d["b"]),
            jnp.asarray(d["h"][:, :ms]), jnp.asarray(d["h"][:, ms:]), jub,
            jnp.asarray(d["x0"]), jnp.asarray(d["y0"]),
            jnp.asarray(d["z0"][:, :ms]), jnp.asarray(d["z0"][:, ms:]),
            dims=(n, me, ms), iters=k, w=8, interpret=True)
        rows = (budget == k).numpy()
        for g, w in zip(got, want):
            g, w = g.numpy()[rows], np.asarray(w)[rows]
            diff = np.abs(g - w)
            outside = diff > SOLVE["atol"] + SOLVE["rtol"] * np.abs(w)
            assert outside.mean() <= 0.01, (k, outside.sum())
            assert diff.max() <= 0.01 * np.abs(w).max(), (k, diff.max())
    for i in (2, 3):
        assert torch.equal(got[0][i], torch.minimum(t["x0"][i], tub))
        assert torch.equal(got[1][i], t["y0"][i])
        assert torch.equal(got[2][i], t["z0"][i, :ms].clamp_min(0))


def test_paired_form_matches_stacked():
    """The paired-row operator is plain PDHG on the stacked [A; S; -S; G]
    system: float64 iterates agree to float reassociation."""
    rng = np.random.default_rng(1)
    n, me, ms, mg = 16, 2, 5, 3
    A, S, G = (rng.normal(size=(m, n)) for m in (me, ms, mg))
    c = rng.uniform(0.5, 2.0, n)
    x_feas = rng.uniform(0.2, 0.8, n)
    b = A @ x_feas
    h_p = S @ x_feas + rng.uniform(0.1, 1.0, ms)
    h_m = -S @ x_feas + rng.uniform(0.1, 1.0, ms)
    h_g = G @ x_feas + rng.uniform(0.1, 1.0, mg)
    f64 = dict(dtype=torch.float64, device="cpu")

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64)[None]

    lb, ub = torch.zeros(n, dtype=torch.float64), torch.ones(
        n, dtype=torch.float64)
    h = t(np.concatenate([h_p, h_m, h_g]))
    paired = tlp.solve_lp(tlp.make_lp_operator(A, G, iters=3000, sym=S,
                                               **f64), t(c), t(b), h, lb, ub)
    stacked = tlp.solve_lp(tlp.make_lp_operator(A, np.vstack([S, -S, G]),
                                                iters=3000, **f64),
                           t(c), t(b), h, lb, ub)
    for field in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(paired, field).numpy(),
                                   getattr(stacked, field).numpy(),
                                   rtol=1e-8, atol=1e-8, err_msg=field)
    # and both solve the LP the JAX package's solver solves
    jsol = jlp.solve_lp(jlp.make_lp_operator(A, G, iters=3000,
                                             dtype=jnp.float64, sym=S),
                        jnp.asarray(c), jnp.asarray(b), jnp.asarray(h[0]),
                        jnp.zeros(n), jnp.ones(n))
    np.testing.assert_allclose(paired.x[0].numpy(), np.asarray(jsol.x),
                               rtol=1e-8, atol=1e-8)


def test_merged_blocks_and_relaxation_match_jax():
    """The merged [A; S] products and over-relaxation options compute the
    JAX package's iterations (float32, rtol 1e-4 / atol 2e-3)."""
    env_j, jp = jem.make_env(lp_iters=40, lp_merge=True, lp_relax=1.5)
    env_t, tp = tem.make_env(lp_iters=40, lp_merge=True, lp_relax=1.5,
                             device="cpu")
    assert tp.op.merge_blocks and tp.op.relax == 1.5
    assert not tem.uses_solve_kernel(tp)
    d = _problem(tp.op, 4, seed=6)
    jsol = jlp.solve_lp(jp.op, *(jnp.asarray(d[k]) for k in "cbh"),
                        jnp.zeros_like(jp.ub), jp.ub,
                        init=jlp.LPSolution(*(jnp.asarray(d[k])
                                              for k in ("x0", "y0", "z0"))))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tsol = tlp.solve_lp(tp.op, t["c"], t["b"], t["h"], torch.zeros_like(tp.ub),
                        tp.ub, init=tlp.LPSolution(t["x0"], t["y0"], t["z0"]))
    for field in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(tsol, field).numpy(),
                                   np.asarray(getattr(jsol, field)), **SOLVE,
                                   err_msg=field)


def test_make_lp_operator_defaults_to_the_card():
    """The operator builds on the card unless asked for the CPU; without a
    card the default raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlp.make_lp_operator(np.ones((1, 3)), np.zeros((0, 3)))
