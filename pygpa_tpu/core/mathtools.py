"""Mathematical utilities (JAX counterpart of pyGPA.mathtools).

All array functions are pure jnp, jittable, and dtype-preserving.
Host-side helpers that feed tiny k-vector lists (standardize_ks,
remove_negative_duplicates) intentionally work on numpy arrays: they
run once per image on O(10) vectors and contain data-dependent shapes.

Reference behavior: /root/reference/pyGPA/mathtools.py
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def wrap_to_pi(x):
    """Wrap all values of x to the interval (-pi, pi].

    Matches pyGPA.mathtools.wrapToPi (mathtools.py:72-75).
    """
    return (x + jnp.pi) % (2 * jnp.pi) - jnp.pi


# pyGPA-compatible alias
wrapToPi = wrap_to_pi


def periodic_average(X, period=2 * np.pi, weights=1.0, **kwargs):
    """Weighted circular mean of X with arbitrary period.

    Matches pyGPA.mathtools.periodic_average (mathtools.py:6-10):
    average the unit phasors and return the angle rescaled to `period`.
    """
    phx = (2 * jnp.pi / period) * X
    Y = weights * jax.lax.complex(jnp.cos(phx), jnp.sin(phx))
    Y = jnp.angle(jnp.mean(Y, **kwargs))
    return Y * period / (2 * jnp.pi)


def periodic_difference(X, Y, period=2 * np.pi):
    """Periodic difference of X and Y (mathtools.py:13-17)."""
    phz = (2 * jnp.pi / period) * (X - Y)
    Z = jax.lax.complex(jnp.cos(phz), jnp.sin(phz))
    return jnp.angle(Z) * period / (2 * jnp.pi)


@partial(jax.jit, static_argnames=("iters",))
def _fit_plane_irls(image, mask, f_scale, iters):
    """Huber-loss plane fit via iteratively reweighted least squares.

    Minimizes sum(rho(r_i / f_scale)) for r = image - (ax*x + ay*y + b)
    with the Huber loss, the same M-estimate that
    scipy.optimize.least_squares(loss='huber') converges to in
    pyGPA.mathtools.fit_plane (mathtools.py:30-47). IRLS weights are
    w_i = min(1, f_scale/|r_i|); each step solves the 3x3 weighted
    normal equations in closed form, so the whole fit is a handful of
    fused reductions on device rather than a host-side optimizer.
    """
    nx, ny = image.shape
    dt = image.dtype
    xx = jnp.arange(nx, dtype=dt)[:, None]
    yy = jnp.arange(ny, dtype=dt)[None, :]
    img = jnp.where(mask, image, 0.0)
    maskf = mask.astype(dt)

    def solve(w):
        # design matrix columns: x, y, 1 ; accumulate A^T W A and A^T W r
        wm = w * maskf
        sx = jnp.sum(wm * xx * xx)
        sxy = jnp.sum(wm * xx * yy)
        sy = jnp.sum(wm * yy * yy)
        sx1 = jnp.sum(wm * xx)
        sy1 = jnp.sum(wm * yy)
        s1 = jnp.sum(wm)
        A = jnp.array([[sx, sxy, sx1], [sxy, sy, sy1], [sx1, sy1, s1]])
        bx = jnp.sum(wm * xx * img)
        by = jnp.sum(wm * yy * img)
        b1 = jnp.sum(wm * img)
        rhs = jnp.array([bx, by, b1])
        return jnp.linalg.solve(A, rhs)

    def body(_, p):
        r = img - (p[0] * xx + p[1] * yy + p[2])
        w = jnp.minimum(1.0, f_scale / jnp.maximum(jnp.abs(r), 1e-30))
        return solve(w)

    p0 = solve(jnp.ones_like(image))
    return jax.lax.fori_loop(0, iters, body, p0)


def lfit_func(x, image, xx, yy):
    """Plane residuals (mathtools.py:20-23)."""
    ax, ay, b = x
    return jnp.ravel(image - (ax * xx + ay * yy + b))


def lfit_func_mask(x, image, xx, yy, mask):
    """Masked plane residuals (mathtools.py:25-27)."""
    ax, ay, b = x
    return jnp.ravel(jnp.where(mask, image - (ax * xx + ay * yy + b),
                               0.0))


def fit_plane(image, verbose=False, iters=60, f_scale=1.0):
    """Fit a plane a0*x + a1*y + a2 through `image` with Huber loss.

    Drop-in for pyGPA.mathtools.fit_plane (mathtools.py:30-47).
    Returns the 3-vector (a0, a1, a2).
    """
    image = jnp.asarray(image)
    return _fit_plane_irls(image, jnp.ones(image.shape, bool), f_scale, iters)


def fit_plane_masked(image, verbose=False, mask=False, iters=60, f_scale=1.0):
    """fit_plane over a boolean mask (mathtools.py:50-69)."""
    image = jnp.asarray(image)
    if mask is False or mask is None:
        mask = jnp.ones(image.shape, bool)
    return _fit_plane_irls(image, jnp.asarray(mask, bool), f_scale, iters)


def remove_negative_duplicates(ks, atol_scale="min"):
    """Drop negative duplicates from a list of 2-vectors.

    Host-side (tiny input, data-dependent output shape). Canonicalizes
    each vector so its x-coordinate (or y if x == 0) is non-negative,
    then removes near-duplicates. Matches pyGPA.mathtools.
    remove_negative_duplicates (mathtools.py:78-94); the GPA-module
    variant (geometric_phase_analysis.py:371-385) uses a norm-based
    atol, selected with atol_scale="norm".
    """
    ks = np.asarray(ks)
    if ks.shape[0] == 0:
        return ks
    nonneg = np.where(np.sign(ks[:, [0]]) != 0,
                      np.sign(ks[:, [0]]) * ks,
                      np.sign(ks[:, [1]]) * ks)
    if atol_scale == "norm":
        atol = 1e-5 * np.linalg.norm(nonneg, axis=1).mean()
    else:
        atol = 1e-3 * np.min(np.abs(nonneg), axis=1).mean()
    npks = [nonneg[0]]
    for k in nonneg[1:]:
        if not np.any(np.all(np.isclose(k, npks, atol=atol), axis=1)):
            npks.append(k)
    return np.array(npks)


def standardize_ks(kvecs):
    """Standardize order and quadrant of a lattice's k-vectors.

    Returns the three vectors closest to zero angle, sorted by angle.
    Matches pyGPA.mathtools.standardize_ks (mathtools.py:97-113).
    """
    newvecs = remove_negative_duplicates(np.asarray(kvecs))
    newvecs = np.concatenate([newvecs, -newvecs], axis=0)
    angles = np.arctan2(*newvecs.T[::-1])
    ind = np.argsort(np.abs(angles))[:3]
    ind = ind[np.argsort(angles[ind])]
    return newvecs[ind]
