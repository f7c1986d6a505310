"""Per-pixel weighted least squares, closed form.

The reference solves, for every pixel, min_x ||w * (K x - b)|| with K
the (d, 2) stack of 2*pi*k-vectors, via a numba prange loop calling
np.linalg.lstsq per pixel (myweighed_lstsq,
/root/reference/pyGPA/geometric_phase_analysis.py:97-113 — HOT LOOP #2
of the pipeline). Since K has only 2 columns, the normal equations are
a 2x2 system per pixel; the whole field reduces to a handful of
fused elementwise multiplies + a closed-form 2x2 solve, no loop and no
LAPACK.
"""
import jax.numpy as jnp


def weighted_lstsq_stack(b, K, w, rcond_eps=0.0):
    """Solve min_x ||w*(K @ x - b)|| independently per trailing position.

    Parameters
    ----------
    b : (d, ...) array — right-hand sides per pixel.
    K : (d, 2) array — shared design matrix (2*pi*kvecs).
    w : (d, ...) array — per-pixel weights.

    Returns
    -------
    x : (2, ...) array.

    Weighted normal equations A x = r with
    A = sum_d w_d^2 K_d K_d^T (2x2 SPD), r = sum_d w_d^2 K_d b_d,
    solved with the explicit 2x2 inverse. Degenerate A (all weights
    zero) yields 0/0 -> nan, matching np.linalg.lstsq's behavior on
    zero rows closely enough for the pipeline (weights carry a 1e-6
    floor there, geometric_phase_analysis.py:926).
    """
    b = jnp.asarray(b)
    K = jnp.asarray(K, b.dtype if not jnp.iscomplexobj(b) else None)
    w = jnp.asarray(w)
    ww = w * w
    shape = (K.shape[0],) + (1,) * (b.ndim - 1)
    k0 = K[:, 0].reshape(shape)
    k1 = K[:, 1].reshape(shape)
    a00 = jnp.sum(ww * k0 * k0, axis=0)
    a01 = jnp.sum(ww * k0 * k1, axis=0)
    a11 = jnp.sum(ww * k1 * k1, axis=0)
    r0 = jnp.sum(ww * k0 * b, axis=0)
    r1 = jnp.sum(ww * k1 * b, axis=0)
    det = a00 * a11 - a01 * a01
    if rcond_eps:
        det = det + rcond_eps
    x0 = (a11 * r0 - a01 * r1) / det
    x1 = (a00 * r1 - a01 * r0) / det
    return jnp.stack([x0, x1])
