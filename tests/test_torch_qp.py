"""PyTorch port of the projections (sustaingym_tpu_torch.ops.qp: dual
FISTA and ADMM) against the JAX package's ops.qp on the same seeded
inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sustaingym_tpu.envs.evcharging import sites as jsites
from sustaingym_tpu.ops import qp as jqp
from sustaingym_tpu_torch.envs.evcharging import sites as tsites
from sustaingym_tpu_torch.ops import qp as tqp


def _ops(site, inner_bf16=False, **kw):
    spec = jsites.load_site(site)
    jop = jqp.make_dual_soc_projection(
        spec.constraint_matrix, spec.phase_angles, spec.magnitudes,
        action_scale=32.0, iters=15, inner_bf16=inner_bf16, **kw)
    tspec = tsites.load_site(site)
    top = tqp.make_dual_soc_projection(
        tspec.constraint_matrix, tspec.phase_angles, tspec.magnitudes,
        action_scale=32.0, iters=15, device="cpu", **kw)
    return jop, top


def _inputs(n, seed, batch=128):
    """Uniform actions with ub = 1 on most stations, so the network cones
    bind (the projection does real work), plus some tight boxes."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    ub = np.where(rng.uniform(size=(batch, n)) < 0.8, 1.0,
                  rng.uniform(0, 1, (batch, n))).astype(np.float32)
    return a, ub


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_operator_constants_match(site):
    jop, top = _ops(site)
    for name in ("C", "radii", "step"):
        np.testing.assert_allclose(getattr(top, name).numpy(),
                                   np.asarray(getattr(jop, name)),
                                   rtol=0, atol=1e-6)
    assert (top.n, top.m, top.iters, top.restart) == (
        jop.n, jop.m, jop.iters, jop.restart)


@pytest.mark.parametrize("site", ["caltech", "jpl"])
@pytest.mark.parametrize("inner_bf16,tol", [(False, 1e-5), (True, 2e-2)])
def test_project_matches_jax(site, inner_bf16, tol):
    """f32 port == JAX f32 chain to 1e-5; against the JAX default bf16
    inner chain to its bf16 noise (2e-2)."""
    jop, top = _ops(site, inner_bf16=inner_bf16)
    a, ub = _inputs(top.n, seed=1)
    xj = np.asarray(jqp.project(jop, jnp.asarray(a), jnp.asarray(ub)))
    xt = tqp.project(top, torch.from_numpy(a), torch.from_numpy(ub)).numpy()
    assert xt.dtype == np.float32
    # the cones bind: the projection moved the point
    assert np.abs(xt - np.minimum(a, ub)).max() > 0.05
    assert np.abs(xt - xj).max() <= tol, np.abs(xt - xj).max()


def test_project_no_restart_matches_jax():
    """restart=False with the provable spectral step."""
    jop, top = _ops("caltech", step_scale=None, restart=False)
    a, ub = _inputs(top.n, seed=2)
    xj = np.asarray(jqp.project(jop, jnp.asarray(a), jnp.asarray(ub)))
    xt = tqp.project(top, torch.from_numpy(a), torch.from_numpy(ub)).numpy()
    assert np.abs(xt - xj).max() <= 1e-5


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_feasible_input_unchanged(site):
    """A point inside the box and every cone is its own projection."""
    jop, top = _ops(site)
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 0.01, (16, top.n)).astype(np.float32)
    ub = np.ones_like(a)
    xt = tqp.project(top, torch.from_numpy(a), torch.from_numpy(ub)).numpy()
    np.testing.assert_array_equal(xt, a)
    xj = np.asarray(jqp.project(jop, jnp.asarray(a), jnp.asarray(ub)))
    np.testing.assert_array_equal(xj, a)


def _admm_ops(site, iters=30, **kw):
    spec = jsites.load_site(site)
    jop = jqp.make_soc_projection(spec.constraint_matrix, spec.phase_angles,
                                  spec.magnitudes, action_scale=32.0,
                                  iters=iters, **kw)
    tspec = tsites.load_site(site)
    top = tqp.make_soc_projection(tspec.constraint_matrix,
                                  tspec.phase_angles, tspec.magnitudes,
                                  action_scale=32.0, iters=iters,
                                  device="cpu")
    return jop, top


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_admm_operator_matches_jax(site):
    """K inverted in float64 on the host, stored float32: every field of
    the port's ADMM operator equals the JAX package's (rtol 1e-6)."""
    jop, top = _admm_ops(site)
    for name in ("C", "K", "radii"):
        np.testing.assert_allclose(getattr(top, name).numpy(),
                                   np.asarray(getattr(jop, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
        assert getattr(top, name).dtype == torch.float32
    for name in ("rho", "alpha"):
        assert getattr(top, name) == float(getattr(jop, name))
    assert (top.n, top.m, top.iters) == (jop.n, jop.m, jop.iters)


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_admm_project_matches_jax(site):
    """project() dispatches an SOCProjection to ADMM, which runs the JAX
    package's _project_admm: in float64 (both operators built from the
    same float64 constants and float32 alpha) they agree to 1e-10. In
    float32 the two sum their products in another order, which ADMM's
    dual accumulators carry through 30 iterations: each package's float32
    result is ~3e-5 from its float64 one at both sites, so float32 is held
    to 1e-4 (the tolerance rtol 1e-5 / atol 1e-6 lies below that noise)."""
    alpha = float(np.float32(1.7))
    jop, top = _admm_ops(site, alpha=alpha)
    a, ub = _inputs(top.n, seed=1)
    xj = np.asarray(jqp.project(jop, jnp.asarray(a), jnp.asarray(ub)))
    xt = tqp.project(top, torch.from_numpy(a), torch.from_numpy(ub)).numpy()
    assert xt.dtype == np.float32
    assert np.abs(xt - np.minimum(a, ub)).max() > 0.05   # the cones bind
    assert (xt >= 0).all() and (xt <= ub).all()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-4)

    j64, _ = _admm_ops(site, alpha=alpha, dtype=jnp.float64)
    t64 = dataclasses.replace(
        top, C=torch.tensor(np.asarray(j64.C)),
        K=torch.tensor(np.asarray(j64.K)),
        radii=torch.tensor(np.asarray(j64.radii)))
    xj64 = np.asarray(jqp.project(j64, jnp.asarray(a, jnp.float64),
                                  jnp.asarray(ub, jnp.float64)))
    xt64 = tqp.project(t64, torch.from_numpy(a).double(),
                       torch.from_numpy(ub).double()).numpy()
    np.testing.assert_allclose(xt64, xj64, rtol=0, atol=1e-10)
