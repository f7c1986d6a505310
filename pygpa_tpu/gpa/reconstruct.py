"""Displacement-field reconstruction from GPA phases.

Reference behavior: /root/reference/pyGPA/geometric_phase_analysis.py:
92-245 (fit_delta_k, myweighed_lstsq, reconstruct_u_inv*,
iterate_GPA). The numba per-pixel lstsq loop becomes the closed-form
batched solver in solvers.lstsq; the per-component unwrap integrations
run as two vmapped CG solves.
"""
import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULTS
from ..core.mathtools import wrap_to_pi, fit_plane
from ..solvers.lstsq import weighted_lstsq_stack
from ..solvers.unwrap import (phase_unwrap, phase_unwrap_prediff,
                              phase_unwrap_prediff_mg)
from ..ops.lockin import gpa_lockin


def myweighed_lstsq(b, K, w):
    """Weighted per-pixel lstsq, pyGPA-compatible name
    (geometric_phase_analysis.py:97-113)."""
    return weighted_lstsq_stack(b, K, w)


def fit_delta_k(phases):
    """Plane-fit slope of a phase map over 2*pi — the k-correction used
    by iterate_GPA (geometric_phase_analysis.py:92-94)."""
    x_opt = fit_plane(phases)
    return x_opt[:2] / (2 * jnp.pi)


def reconstruct_u_inv(kvecs, b, weights=None, use_only_ks=None):
    """Reconstruct u from unwrapped phases b along kvecs by solving
    2*pi*K u = b per pixel (geometric_phase_analysis.py:157-193)."""
    kvecs = jnp.asarray(kvecs)
    b = jnp.asarray(b)
    K = 2 * jnp.pi * kvecs
    b = b - b.mean(axis=(-2, -1), keepdims=True)
    if use_only_ks is None:
        if weights is None:
            weights = jnp.ones_like(b)
        return weighted_lstsq_stack(b, K, weights)
    assert len(use_only_ks) == 2
    idx = jnp.asarray(use_only_ks)
    Kinv = jnp.linalg.inv(K[idx])
    us = jnp.einsum("ij,j...->i...", Kinv, b[idx],
                    precision=jax.lax.Precision.HIGHEST)
    return us


def reconstruct_u_inv_from_phases(kvecs, phases, weights,
                                  weighted_unwrap=True, pre_diff=False,
                                  kmax=10):
    """Reconstruct u from *wrapped* phases: wrap-difference the phases,
    weighted-lstsq the per-pixel gradients, then integrate each
    component with the weighted phase unwrapper
    (geometric_phase_analysis.py:196-245). This is the numerically
    preferred path used by extract_displacement_field."""
    kvecs = jnp.asarray(kvecs)
    phases = jnp.asarray(phases)
    weights = jnp.asarray(weights)
    K = 2 * jnp.pi * kvecs
    if pre_diff:
        dbdx = wrap_to_pi(phases[..., 0])[:, :, :-1]
        dbdy = wrap_to_pi(phases[..., 1])[:, :-1]
    else:
        dbdx = wrap_to_pi(jnp.diff(phases, axis=2))
        dbdy = wrap_to_pi(jnp.diff(phases, axis=1))
    # weights for the x-diff span M-1 columns, the y-diff N-1 rows
    # (the reference passes the full-size weights to numba lstsq, which
    # broadcasts per-pixel; shapes must match exactly here)
    dudx = weighted_lstsq_stack(dbdx, K, weights[:, :, : dbdx.shape[2]])
    dudy = weighted_lstsq_stack(dbdy, K, weights[:, : dbdy.shape[1], :])
    if weighted_unwrap:
        wnorm = jnp.linalg.norm(weights, axis=0)
        unwrap = jax.vmap(lambda dx, dy: phase_unwrap_prediff(
            dx, dy, wnorm, kmax=kmax))
    else:
        unwrap = jax.vmap(lambda dx, dy: phase_unwrap_prediff(dx, dy))
    return unwrap(dudx, dudy)


def refine_ks(image, kvecs, sigma=None, iters=3,
              kmax_iter=DEFAULTS.unwrap_kmax_iterate):
    """Refine detected k-vectors to sub-grid accuracy via the
    iterate_GPA plane-fit loop (detected peaks are limited to ~1/size;
    displacement extraction with unrefined ks leaks a delta_k * r ramp
    into u). Returns the corrected k-vectors (host numpy)."""
    kvecs = np.asarray(kvecs)
    if sigma is None:
        sigma = int(np.ceil(1 / np.linalg.norm(kvecs, axis=1).min()))
    _, _, corr = iterate_GPA(image, kvecs, sigma, iters=iters,
                             kmax_iter=kmax_iter, kmax=kmax_iter)
    return kvecs + np.asarray(corr)


def reconstruct_u_inv_from_demod(kvecs, phases_demod, weights, kmax=10,
                                 unwrap_coarse=None, refine_iters=3):
    """Reconstruction from *demodulated* WFR phases (phase measured
    relative to each k's own plane wave, i.e. full phase =
    phases_demod + 2 pi k . r). The plane-wave ramp enters the wrapped
    phase differences only as a constant per-axis shift, so the
    full-size complex rebase of the lock-in signals is skipped — the
    fast path used by make_displacement_extractor. Mathematically
    identical to reconstruct_u_inv_from_phases on rebased phases."""
    kvecs = jnp.asarray(kvecs)
    phases_demod = jnp.asarray(phases_demod)
    K = 2 * jnp.pi * kvecs
    dbdx = wrap_to_pi(jnp.diff(phases_demod, axis=2)
                      + K[:, 1, None, None])
    dbdy = wrap_to_pi(jnp.diff(phases_demod, axis=1)
                      + K[:, 0, None, None])
    dudx = weighted_lstsq_stack(dbdx, K, weights[:, :, : dbdx.shape[2]])
    dudy = weighted_lstsq_stack(dbdy, K, weights[:, : dbdy.shape[1], :])
    wnorm = jnp.linalg.norm(weights, axis=0)
    # two vmapped weighted unwraps over the component axis
    # (geometric_phase_analysis.py:239-242)
    if unwrap_coarse:
        kmg = min(int(kmax), DEFAULTS.unwrap_kmax_mg)
        unwrap = jax.vmap(lambda dx, dy: phase_unwrap_prediff_mg(
            dx, dy, wnorm, kmax=kmg, coarse=unwrap_coarse,
            refine_iters=refine_iters))
    else:
        unwrap = jax.vmap(lambda dx, dy: phase_unwrap_prediff(
            dx, dy, wnorm, kmax=kmax))
    return unwrap(dudx, dudy)


def iterate_GPA(image, kvecs, sigma, edge=5, iters=3,
                kmax_iter=DEFAULTS.unwrap_kmax_iterate,
                kmax=DEFAULTS.unwrap_kmax_final, verbose=False):
    """Iteratively refine the reference k-vectors: lock-in -> unwrap ->
    plane-fit the phase -> shift k by slope/2*pi, then a final unwrap
    with larger kmax (geometric_phase_analysis.py:116-154).

    Returns (unwrapped phases, weights, k-corrections)."""
    image = jnp.asarray(image)
    kvecs = np.asarray(kvecs)
    corr = jnp.zeros(kvecs.shape, image.dtype)
    kv = jnp.asarray(kvecs, image.dtype)

    def lockins(corr):
        rs = jnp.stack([gpa_lockin(image, k, sigma) for k in (kv + corr)])
        if edge > 0:
            rs = rs[:, edge:-edge, edge:-edge]
        return jnp.angle(rs), jnp.abs(rs)

    for i in range(iters + 1):
        prs, w = lockins(corr)
        wn = jnp.sqrt(w / w.max(axis=(-2, -1), keepdims=True))
        if i < iters:
            unwrapped = jax.vmap(
                lambda p, we: phase_unwrap(p, we, kmax=kmax_iter))(prs, wn)
            delta_ks = jnp.stack([fit_delta_k(pr) for pr in unwrapped])
            if verbose:
                print(delta_ks)
            corr = corr - delta_ks
        else:
            unwrapped = jax.vmap(
                lambda p, we: phase_unwrap(p, we, kmax=kmax))(prs, wn)
    return unwrapped, w, corr
