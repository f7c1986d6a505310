"""The multigrid unwrap's building blocks vs the NumPy oracle, float64:
the lane-aligned stencil forms (every plane (n, m) with a structurally
zero last column / row), the V-branch pre-smooth chain, the restriction
matmuls, and the aligned PCG loop, against the reference algebra of
/root/reference/pyGPA/phase_unwrap.py:118-207 written on the unaligned
(n, m-1) / (n-1, m) difference arrays."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import pygpa_tpu.solvers.unwrap as U
from reference_impls import (ref_apply_q, ref_phase_unwrap_prediff,
                             ref_residual)


def _case(n=128, m=256, seed=7):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n, m))
    w = 0.1 + 0.9 * rng.random((n, m))
    dx = rng.standard_normal((n, m - 1))
    dy = rng.standard_normal((n - 1, m))
    return phi, dx, dy, w


def _aligned(dx, dy):
    """(n, m-1) / (n-1, m) -> aligned (n, m) planes with a zero tail."""
    return (U._pad_last(jnp.asarray(dx), -1),
            U._pad_last(jnp.asarray(dy), -2))


def _ref_dinv(WWx, WWy, omega=U._JACOBI_OMEGA):
    n, m = WWx.shape[0], WWy.shape[1]
    D = np.zeros((n, m))
    D[:, :-1] -= WWx
    D[:, 1:] -= WWx
    D[:-1, :] -= WWy
    D[1:, :] -= WWy
    out = np.zeros_like(D)
    big = np.abs(D) > 1e-8
    out[big] = omega / D[big]
    return out


def _smooth_problem(n, seed=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 4 * np.pi, n)
    psi = np.sin(x)[:, None] * np.cos(0.7 * x)[None, :] * 5.0
    w = 0.2 + 0.8 * rng.random((n, n))
    return np.diff(psi, axis=-1), np.diff(psi, axis=-2), w


@pytest.mark.parametrize("cr", [2, 4])
def test_vbranch_presmooth_chain_matches_numpy(cr):
    """Residual gradients, min-neighbour weights, residual, Jacobi
    diagonal, pre-smoothed d and r, then the cr x cr restriction — the
    V-branch's first half — entry for entry."""
    phi, dx, dy, w = _case()
    dxp, dyp = _aligned(dx, dy)
    ph = jnp.asarray(phi)
    rdx = dxp - U._mask_last(jnp.roll(ph, -1, -1) - ph, -1)
    rdy = dyp - U._mask_last(jnp.roll(ph, -1, -2) - ph, -2)
    rk, WWx, WWy = U._residual_aligned(rdx, rdy, jnp.asarray(w))
    Dinv = U._jacobi_dinv_aligned(WWx, WWy)
    d = rk * Dinv
    r = rk - U._apply_q_aligned(d, WWx, WWy)
    n, m = phi.shape
    rc = U._sep2(r.reshape(n // cr, cr, m).mean(axis=1), None,
                 U._avg_right(m, m // cr, cr, r.dtype))

    rk_r, WWx_r, WWy_r = ref_residual(dx - np.diff(phi, axis=1),
                                      dy - np.diff(phi, axis=0), w)
    Dinv_r = _ref_dinv(WWx_r, WWy_r)
    d_r = rk_r * Dinv_r
    r_r = rk_r - ref_apply_q(d_r, WWx_r, WWy_r)
    rc_r = r_r.reshape(n // cr, cr, m // cr, cr).mean(axis=(1, 3))
    for name, a, b in (("rk", rk, rk_r), ("Dinv", Dinv, Dinv_r),
                       ("d", d, d_r), ("r", r, r_r), ("restrict", rc, rc_r)):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(np.asarray(WWx)[:, -1], 0.0)
    np.testing.assert_array_equal(np.asarray(WWy)[-1, :], 0.0)


def test_apply_q_aligned_matches_numpy():
    phi, dx, dy, w = _case(seed=9)
    dxp, dyp = _aligned(dx, dy)
    _, WWx, WWy = U._residual_aligned(dxp, dyp, jnp.asarray(w))
    _, WWx_r, WWy_r = ref_residual(dx, dy, w)
    got = U._apply_q_aligned(jnp.asarray(phi), WWx, WWy)
    np.testing.assert_allclose(np.asarray(got),
                               ref_apply_q(phi, WWx_r, WWy_r), atol=1e-12)


def test_apply_q_aligned_vmapped_components():
    """The production call shape: vmapped over the two displacement
    components with the weight planes closed over (unbatched)."""
    phi, dx, dy, w = _case(seed=5)
    dxp, dyp = _aligned(dx, dy)
    _, WWx, WWy = U._residual_aligned(dxp, dyp, jnp.asarray(w))
    pb = jnp.stack([jnp.asarray(phi), 2.0 * jnp.asarray(phi)])
    got = jax.vmap(lambda p: U._apply_q_aligned(p, WWx, WWy))(pb)
    _, WWx_r, WWy_r = ref_residual(dx, dy, w)
    for i, s in enumerate((1.0, 2.0)):
        np.testing.assert_allclose(np.asarray(got[i]),
                                   ref_apply_q(s * phi, WWx_r, WWy_r),
                                   atol=1e-12)


@pytest.mark.parametrize("final", ["v", "vv"])
def test_mg_vbranch_final_level(final):
    """The V-branch finest level moves the coarse solution towards the
    converged NumPy solve, and the component vmap equals the loop."""
    n = 256
    dx, dy, w = _smooth_problem(n)
    ref = ref_phase_unwrap_prediff(dx, dy, w, kmax=400)

    def run(sched, a, b):
        return U.phase_unwrap_prediff_mg(a, b, jnp.asarray(w), kmax=6,
                                         schedule=sched)

    def err(a):
        d = np.asarray(a) - ref
        return np.sqrt(((d - d.mean()) ** 2).mean())

    dxj, dyj = jnp.asarray(dx), jnp.asarray(dy)
    coarse = run(((4, 6),), dxj, dyj)
    fine = run(((4, 6), (1, final)), dxj, dyj)
    assert err(fine) < 0.5 * err(coarse), (err(fine), err(coarse))
    both = jax.vmap(lambda a, b: run(((4, 6), (1, final)), a, b))(
        jnp.stack([dxj, 0.5 * dxj]), jnp.stack([dyj, 0.5 * dyj]))
    np.testing.assert_allclose(np.asarray(both[0]), np.asarray(fine),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(both[1]),
                               np.asarray(run(((4, 6), (1, final)),
                                              0.5 * dxj, 0.5 * dyj)),
                               atol=1e-10)


def test_mg_precond_factory_hook():
    """A precond_factory (the distributed solver's hook) that builds the
    same unweighted-Poisson DCT solve reproduces the default path."""
    n = 128
    dx, dy, w = _smooth_problem(n, seed=4)
    args = (jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(w))
    solvers = {}

    def factory(shape):
        if shape not in solvers:
            scale = U._poisson_scale(shape, jnp.float64)
            solvers[shape] = lambda rk: U.solve_poisson(rk, scale)
        return solvers[shape]

    ref = U.phase_unwrap_prediff_mg(*args, kmax=6, coarse=4)
    got = U.phase_unwrap_prediff_mg(*args, kmax=6, coarse=4,
                                    precond_factory=factory)
    assert set(solvers) >= {(32, 32), (64, 64)}
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-10)


@pytest.mark.parametrize("coarse", [8, 16])
def test_mg_large_coarse_factors(coarse):
    """Coarse factors beyond the default restrict and prolong correctly:
    the result stays close to the converged solve."""
    n = 256
    dx, dy, w = _smooth_problem(n, seed=6)
    ref = ref_phase_unwrap_prediff(dx, dy, w, kmax=400)
    got = np.asarray(U.phase_unwrap_prediff_mg(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(w), kmax=10,
        coarse=coarse))
    d = got - ref
    d -= d.mean()
    assert np.isfinite(got).all()
    assert np.sqrt((d ** 2).mean()) < 0.05 * np.abs(ref - ref.mean()).max()


@pytest.fixture
def system():
    n = 256
    dx, dy, w = _smooth_problem(n, seed=5)
    dxp, dyp = _aligned(dx, dy)
    return (dx, dy, w), U._residual_aligned(dxp, dyp, jnp.asarray(w))


@pytest.mark.parametrize("kmax", [1, 4, 6])
def test_cg_aligned_matches_numpy_pcg(system, kmax):
    (dx, dy, w), (rk, WWx, WWy) = system
    got, k = U._cg_unwrap(rk, WWx, WWy, kmax, aligned=True)
    ref, kr = ref_phase_unwrap_prediff(dx, dy, w, kmax=kmax,
                                       return_iters=True)
    assert int(k) == kr == kmax
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-10)


def test_cg_zero_rhs(system):
    _, (_, WWx, WWy) = system
    got, k = U._cg_unwrap(jnp.zeros_like(WWx), WWx, WWy, 4, aligned=True)
    assert int(k) == 0
    np.testing.assert_array_equal(np.asarray(got), 0.0)


def test_cg_rectangular():
    rng = np.random.default_rng(9)
    n, m = 128, 256
    w = 0.2 + 0.8 * rng.random((n, m))
    dx = 0.5 * rng.standard_normal((n, m - 1))
    dy = 0.5 * rng.standard_normal((n - 1, m))
    dxp, dyp = _aligned(dx, dy)
    rk, WWx, WWy = U._residual_aligned(dxp, dyp, jnp.asarray(w))
    got, _ = U._cg_unwrap(rk, WWx, WWy, 5, aligned=True)
    ref = ref_phase_unwrap_prediff(dx, dy, w, kmax=5)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-10)


def test_cg_unweighted_stops_after_one_step():
    """With unit weights the DCT preconditioner is the exact inverse:
    the loop stops on its residual test after one iteration and returns
    the Poisson solution."""
    rng = np.random.default_rng(2)
    n = 128
    dx = 0.3 * rng.standard_normal((n, n - 1))
    dy = 0.3 * rng.standard_normal((n - 1, n))
    dxp, dyp = _aligned(dx, dy)
    rk, WWx, WWy = U._residual_aligned(dxp, dyp, None)
    got, k = U._cg_unwrap(rk, WWx, WWy, 50, aligned=True)
    assert int(k) == 1
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(U.solve_poisson(rk)), atol=1e-10)


def test_cg_iteration_count_matches_numpy():
    """The data-dependent stop (relative residual 1e-9 in float64)
    fires at the same iteration as the NumPy oracle's."""
    dx, dy, w = _smooth_problem(64, seed=8)
    phi, k = U.phase_unwrap_prediff(jnp.asarray(dx), jnp.asarray(dy),
                                    jnp.asarray(w), kmax=500,
                                    return_iters=True)
    ref, kr = ref_phase_unwrap_prediff(dx, dy, w, kmax=500,
                                       return_iters=True)
    assert kr < 500
    assert abs(int(k) - kr) <= 1
    np.testing.assert_allclose(np.asarray(phi), ref, atol=1e-7)


def test_mg_default_schedule_512():
    """The production schedule (coarse 4: 6 CG iterations, one
    mid-level iteration below 1024 px, V-branch finest level) at 512^2
    lands close to the converged NumPy solve."""
    n = 512
    dx, dy, w = _smooth_problem(n)
    ref = ref_phase_unwrap_prediff(dx, dy, w, kmax=400)
    got = np.asarray(U.phase_unwrap_prediff_mg(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(w), kmax=6,
        coarse=4))
    d = got - ref
    d -= d.mean()
    assert np.sqrt((d ** 2).mean()) < 0.02 * np.abs(ref - ref.mean()).max()
