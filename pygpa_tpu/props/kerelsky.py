"""Kerelsky-style moire parameter fits (twist, strain angle,
heterostrain, lattice angle) from measured k-vectors or J fields.

Reference behavior: /root/reference/pyGPA/property_extract.py:581-883.
The reference drives scipy.optimize.least_squares (trust-region with
box bounds) per fit, and maps per-pixel fits over a dask gufunc
(iterate_J_leastsq, :863-883). Here the optimizer is an in-repo
box-projected Levenberg-Marquardt written in pure jnp (jacfwd
Jacobians, fixed-iteration lax.scan) so single fits jit-compile and
per-pixel field fits are one vmapped device program instead of a host
process pool. Multi-start restarts and cost gates mirror the
reference's control flow.

Reference: Kerelsky et al., Nature 572, 95 (2019), Suppl. Note 1.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULTS
from ..core.mathtools import periodic_average, periodic_difference
from ..lattices.transformations import (rotation_matrix, strain_matrix,
                                        a_0_to_r_k,
                                        apply_transformation_matrix)
from ..lattices.generate import generate_ks
from .jacobians import twist_matrix, double_strain_decomp
from ..gpa.kgeometry import calc_diff_from_isotropic


def _mm(a, b):
    # exact matmul (accelerator defaults are bf16/TF32; the LM normal
    # equations are 4x4 — precision here decides convergence depth)
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------- LM core

def _lm_solve(residual_fn, x0, lower, upper, iters=60):
    """Box-projected Levenberg-Marquardt minimizing 0.5*||r(x)||^2.

    Fixed iteration count (static under jit/vmap); Marquardt
    diagonal-scaled damping with accept/reject adaptation. Returns
    (x, cost) with cost = 0.5*sum(r^2) (scipy least_squares convention).
    """
    jac_fn = jax.jacfwd(residual_fn)

    def cost(x):
        r = residual_fn(x)
        return 0.5 * jnp.sum(r * r)

    def body(carry, _):
        x, lam, c = carry
        r = residual_fn(x)
        Jm = jac_fn(x)
        g = _mm(Jm.T, r)
        H = _mm(Jm.T, Jm)
        D = jnp.diag(jnp.diag(H)) + 1e-12 * jnp.eye(x.shape[0], dtype=x.dtype)
        dx = jnp.linalg.solve(H + lam * D, -g)
        xn = jnp.clip(x + dx, lower, upper)
        cn = cost(xn)
        accept = cn < c
        x = jnp.where(accept, xn, x)
        c = jnp.where(accept, cn, c)
        lam = jnp.where(accept, lam * 0.33, lam * 5.0)
        lam = jnp.clip(lam, 1e-12, 1e12)
        return (x, lam, c), None

    x0 = jnp.clip(jnp.asarray(x0, jnp.result_type(float)), lower, upper)
    init = (x0, jnp.asarray(1e-3, x0.dtype), cost(x0))
    (x, _, c), _ = jax.lax.scan(body, init, None, length=iters)
    return x, c


# ------------------------------------------------------------- residuals

def moire_amplitudes(theta, psi, epsilon, a_0=DEFAULTS.a_0):
    """|ks1 - ks2| for a twisted, strained bilayer
    (property_extract.py:581-588)."""
    ks1 = generate_ks(a_0_to_r_k(a_0), 0.0)[:3]
    W = rotation_matrix(jnp.deg2rad(theta))
    V = rotation_matrix(jnp.deg2rad(psi))
    D = strain_matrix(epsilon)
    ks2 = apply_transformation_matrix(ks1, _mm(_mm(_mm(V.T, D), V), W))
    return jnp.linalg.norm(ks1 - ks2, axis=1)


def _moire_diffs_resid(x, lkvecs, nmperpixel):
    """Kerelsky_plus residual (property_extract.py:654-661)."""
    theta, psi, epsilon, xi = x
    ks1 = generate_ks(1.0, xi)[:3]
    W = rotation_matrix(jnp.deg2rad(theta))
    V = rotation_matrix(jnp.deg2rad(psi))
    D = strain_matrix(epsilon)
    ks2 = apply_transformation_matrix(ks1, _mm(_mm(_mm(V.T, D), V), W))
    return jnp.ravel(lkvecs / nmperpixel - (ks2 - ks1)) * 1000


def Jac_fit_diff(x, JacA0):
    """Kerelsky_Jac residual (property_extract.py:696-704)."""
    theta, psi, epsilon, xi = x
    Wxi = rotation_matrix(jnp.deg2rad(xi))
    W = rotation_matrix(jnp.deg2rad(theta + xi))
    V = rotation_matrix(jnp.deg2rad(psi))
    D = strain_matrix(epsilon)
    return jnp.ravel(_mm(_mm(_mm(V.T, D), V), W) - Wxi - JacA0) * 1000


_LOWER4 = jnp.array([0.0, -jnp.inf, 0.0, -jnp.inf])
_UPPER4 = jnp.full(4, jnp.inf)


def _multistart(residual, est):
    """Run the LM from a small bank of starts around `est` — xi shifted
    by -90/0/+90 degrees and psi by 0/90 — and keep the lowest cost.
    The xi landscape is periodic with several basins; scipy's
    trust-region escapes poor starts where a plain LM can run away, so
    the bank makes the in-repo solver at least as robust as the
    reference's two-restart scheme (property_extract.py:666-682)."""
    shifts = jnp.array([[0.0, dpsi, 0.0, dxi]
                        for dxi in (-90.0, 0.0, 90.0)
                        for dpsi in (0.0, 90.0)])
    starts = est[None, :] + shifts

    def one(x0):
        return _lm_solve(residual, x0, _LOWER4, _UPPER4)

    xs, cs = jax.vmap(one)(starts)
    i = jnp.argmin(cs)
    return xs[i], cs[i]


@jax.jit
def _fit_moire_diffs(est, lkvecs, nmperpixel):
    return _multistart(
        lambda x: _moire_diffs_resid(x, lkvecs, nmperpixel), est)


@jax.jit
def _fit_jac(est, JacA0):
    return _multistart(lambda x: Jac_fit_diff(x, JacA0), est)


@jax.jit
def _fit_jac_bank(ests, JacA0):
    """The whole restart bank as ONE device program: every est runs its
    full 6-start _multistart under a vmap over the bank (36 LM solves
    in a single dispatch instead of up to 5 sequential host
    round-trips)."""
    return jax.vmap(
        lambda e: _multistart(lambda x: Jac_fit_diff(x, JacA0), e))(ests)


# ------------------------------------------------------------ public API

def Kerelsky(kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0):
    """Fit (theta, psi, epsilon) to the measured |k| amplitudes
    (property_extract.py:590-601)."""
    knorms = jnp.linalg.norm(jnp.asarray(kvecs), axis=1) * nmperpixel

    def resid(x):
        return (moire_amplitudes(x[0], x[1], x[2], a_0) - knorms) \
            / knorms.mean()

    lower = jnp.array([0.0, -jnp.inf, 0.0])
    upper = jnp.full(3, jnp.inf)
    x, c = _lm_solve(resid, jnp.array([0.01, 0.0, 0.0]), lower, upper)
    if c > 1e-20:
        x2, c2 = _lm_solve(resid, jnp.array([0.01, 90.0, 0.0]),
                           lower, upper)
        if c2 < c:
            x, c = x2, c2
    return np.asarray(x)


def Kerelsky_plus(kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, reference=None,
                  debug=False, sort=0):
    """Fit (theta, psi, epsilon, xi) so generated moire ks match
    `kvecs` (property_extract.py:604-689), with the reference's
    multi-start restarts (psi=90 retry, bound-nudge retry) and the
    cost <= 0.3 acceptance gate. Returns np.nan's if no start
    converges under the gate."""
    kvecs = np.asarray(kvecs)
    angles = np.arctan2(*kvecs.T[::-1])
    r_k0 = float(a_0_to_r_k(a_0))
    lkvecs = kvecs / r_k0
    if sort != 0:
        order = np.argsort(sort * np.asarray(periodic_difference(
            angles, periodic_average(angles))))
        lkvecs = lkvecs[order]
    lk = jnp.asarray(lkvecs)

    est = np.array([0.01, 0.0, 0.0,
                    (np.rad2deg(np.arctan2(lkvecs[0, 1], lkvecs[0, 0]))
                     - 90) % 360])
    x, c = _fit_moire_diffs(jnp.asarray(est), lk, nmperpixel)
    if debug:
        print(est, x, c, sep="\n")
    if c > 1e-20:
        est2 = est.copy()
        est2[1] = 90.0
        x2, c2 = _fit_moire_diffs(jnp.asarray(est2), lk, nmperpixel)
        if c2 < c:
            x, c = x2, c2
    if c > 1e-20:
        active = ((np.asarray(x) <= np.asarray([0.0, -np.inf, 0.0, -np.inf])
                   + 1e-12)
                  & np.isfinite([0.0, -np.inf, 0.0, -np.inf]))
        est3 = np.asarray(x) + 1e-2 * active
        x3, c3 = _fit_moire_diffs(jnp.asarray(est3), lk, nmperpixel)
        if c3 < c:
            x, c = x3, c3
    params = np.asarray(x, dtype=float)
    if not (np.isfinite(c) and c <= 0.3):
        params = np.full(4, np.nan)
    if reference == "symmetric":
        params[3] = params[3] + params[0] / 2
    return params


def _jac_a0(kvecs, nmperpixel, a_0, sort):
    kvecs = np.asarray(kvecs)
    angles = np.arctan2(*kvecs.T[::-1])
    r_k0 = float(a_0_to_r_k(a_0)) * nmperpixel
    lkvecs = kvecs / r_k0
    if sort != 0:
        order = np.argsort(sort * np.asarray(periodic_difference(
            angles, periodic_average(angles))))
        lkvecs = lkvecs[order]
    k0s = np.asarray(generate_ks(1.0, 0.0)[:3])
    A0 = np.linalg.lstsq(k0s, lkvecs, rcond=None)[0].T
    return lkvecs, A0


def Kerelsky_Jac(kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, reference=None,
                 debug=False, sort=0):
    """Fit (theta, psi, epsilon, xi) to the k-space Jacobian JacA0 with
    kvecs = k0s @ JacA0.T (property_extract.py:707-777)."""
    lkvecs, JacA0 = _jac_a0(kvecs, nmperpixel, a_0, sort)
    est = np.array([0.01, 0.0, 0.0,
                    np.rad2deg(np.arctan2(lkvecs[0, 1],
                                          lkvecs[0, 0])) % 360])
    J = jnp.asarray(JacA0)
    x, c = _fit_jac(jnp.asarray(est), J)
    if c > 1e-20:
        # restart bank: the reference's psi=90 nudge
        # (property_extract.py:764-767) plus interior-epsilon starts —
        # the box-projected LM can stick at the epsilon=0 boundary
        # (where psi is unidentifiable) where scipy's reflective TRF
        # escapes; starting strictly inside restores that behavior.
        # All nudged starts run in ONE vmapped dispatch; the winner is
        # then chosen host-side in the reference's sequential order
        # (first start reaching the zero-cost gate wins).
        ests = []
        for nudge in ((None, 90.0), (1e-3, None), (1e-3, 45.0),
                      (1e-3, -45.0), (1e-3, 90.0)):
            est2 = est.copy()
            if nudge[0] is not None:
                est2[2] = nudge[0]
            if nudge[1] is not None:
                est2[1] = nudge[1]
            ests.append(est2)
        xs, cs = _fit_jac_bank(jnp.asarray(np.stack(ests)), J)
        xs = np.asarray(xs)
        cs = np.asarray(cs)
        for x2, c2 in zip(xs, cs):
            if c2 < c:
                x, c = x2, c2
            if c <= 1e-20:
                break
    if debug:
        print(x, c)
    params = np.asarray(x, dtype=float)
    if reference == "symmetric":
        params[3] = params[3] + params[0] / 2
    return params


@partial(jax.jit, static_argnames=())
def _field_fit(JacA0s, refest):
    """vmapped two-start LM over a (..., 2, 2) JacA0 field — the
    device-native replacement of the dask gufunc iterate_J_leastsq
    (property_extract.py:863-883)."""
    flat = JacA0s.reshape(-1, 2, 2)

    def one(Ji):
        x, c = _lm_solve(lambda p: Jac_fit_diff(p, Ji), refest,
                         _LOWER4, _UPPER4)
        alt = refest + jnp.array([0.0, 90.0, 0.0, 0.0])
        x2, c2 = _lm_solve(lambda p: Jac_fit_diff(p, Ji), alt,
                           _LOWER4, _UPPER4)
        use2 = (c > 1e-5) & (c2 < c)
        return jnp.where(use2, x2, x)

    out = jax.vmap(one)(flat)
    return out.reshape(JacA0s.shape[:-2] + (4,))


def iterate_J_leastsq(JacA0s, refest, lq_kwargs=None):
    """Per-pixel Kerelsky fits over a JacA0 field; drop-in for the
    reference's dask gufunc (property_extract.py:863-883)."""
    return _field_fit(jnp.asarray(JacA0s), jnp.asarray(refest))


def Kerelsky_J(J, kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, reference=None,
               debug=False, sort=0, lq_kwargs=None):
    """Field version: fit (theta, psi, epsilon, xi) per pixel of a
    (N, M, 2, 2) J field (property_extract.py:780-860). Returns
    (X (N, M, 4), refest (4,))."""
    lkvecs, A0 = _jac_a0(kvecs, nmperpixel, a_0, sort)
    J = jnp.asarray(J)
    JacA0 = jnp.asarray(A0) + _mm(jnp.asarray(A0), J)
    est = np.array([0.01, 0.0, 0.0,
                    np.rad2deg(np.arctan2(lkvecs[0, 1],
                                          lkvecs[0, 0])) % 360])
    A0j = jnp.asarray(A0)
    x, c = _fit_jac(jnp.asarray(est), A0j)
    if c > 1e-20:
        est2 = est.copy()
        est2[1] = 90.0
        x2, c2 = _fit_jac(jnp.asarray(est2), A0j)
        if c2 < c:
            x, c = x2, c2
    if debug:
        print(x, c)
    refest = np.asarray(x, dtype=float)
    X = iterate_J_leastsq(JacA0, jnp.asarray(refest))
    return X, refest


def moire_props_from_Jac_2_Kerelsky(kvecs, Jac, nmperpixel, a_0=DEFAULTS.a_0,
                                    decomposition=None):
    """(property_extract.py:482-488)."""
    kvecs = jnp.asarray(kvecs)
    dks = calc_diff_from_isotropic(kvecs)
    iso_props = Kerelsky_plus(np.asarray(kvecs + dks), nmperpixel, a_0)
    B0 = twist_matrix(iso_props[0])
    props = double_strain_decomp(_mm(jnp.asarray(Jac), B0))
    return props, iso_props
