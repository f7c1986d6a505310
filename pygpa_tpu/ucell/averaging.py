"""Unit-cell averaging: drizzle every pixel (after undoing the local
displacement u) into a single zoomed unit cell, and the inverse
expansion.

Reference behavior: /root/reference/pyGPA/unit_cell_averaging.py. The
reference compiles a fresh numba closure per (image, ks, z) call and
scatter-adds pixel-by-pixel in a serial double loop (:164-217). Here
the entire drizzle is one jit-compiled program: coordinate mapping and
2x2 bilinear overlap weights are fused elementwise math, and the
accumulation is a single XLA scatter-add over all 4*N*M (bin, value)
pairs. On a GPU that scatter-add runs as atomics, so the summation
order — and with it the last bits of each bin — can change from run to
run; the reference's serial loop is deterministic.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def forward_transform(vecs, ks):
    """Cartesian -> lattice fractional coordinates
    (unit_cell_averaging.py:7-10)."""
    return jnp.matmul(jnp.asarray(vecs), jnp.asarray(ks).T,
                      precision=jax.lax.Precision.HIGHEST)


def backward_transform(vecs, ks):
    """Lattice fractional -> cartesian coordinates
    (unit_cell_averaging.py:13-16)."""
    return jnp.matmul(jnp.asarray(vecs),
                      jnp.linalg.inv(jnp.asarray(ks)).T,
                      precision=jax.lax.Precision.HIGHEST)


def cart_in_uc(vecs, ks, rmin=0):
    """Map cartesian vectors into one unit cell
    (unit_cell_averaging.py:29-34)."""
    return backward_transform(forward_transform(vecs, ks) % 1.0, ks) - rmin


def float_overlap(f):
    """2x2 bilinear overlap weights of a unit square shifted by f
    (unit_cell_averaging.py:37-43)."""
    f = jnp.asarray(f)
    A = jnp.stack([1 - f, f])
    return A[:, 0] * jnp.expand_dims(A[:, 1], 1)


def add_to_position(value, R, res, weights):
    """Functional scatter of one drizzle sample: returns (res, weights)
    with `value` bilinearly distributed at fractional position R —
    the per-pixel primitive of the reference (unit_cell_averaging.py:
    208-217), exposed for API parity. The batched pipeline uses the
    fused scatter in unit_cell_average instead."""
    R = jnp.asarray(R)
    Rf = jnp.floor(R)
    overlap = float_overlap(R - Rf)
    Ri = Rf.astype(jnp.int32)
    for li in range(2):
        for lj in range(2):
            res = res.at[Ri[0] + li, Ri[1] + lj].add(
                value * overlap[li, lj], mode="drop")
            weights = weights.at[Ri[0] + li, Ri[1] + lj].add(
                overlap[li, lj], mode="drop")
    return res, weights


def calc_ucell_parameters(ks, z):
    """Bounding box (rmin, rsize) of the unit cell spanned by ks,
    zoomed by z (unit_cell_averaging.py:45-53). Host-side: rsize
    determines output array shapes."""
    ks = np.asarray(ks)
    corners = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
    cornervals = corners @ np.linalg.inv(ks).T
    rmin = cornervals.min(axis=0)
    rsize = tuple((z * np.ceil(cornervals.max(axis=0)
                               - np.floor(rmin))).astype(int))
    return rmin, rsize


@partial(jax.jit, static_argnames=("rsize", "z"))
def _drizzle(image, u, ks, rmin, rsize, z):
    n, m = image.shape
    dt = image.dtype
    A = jnp.asarray(ks, dt)
    Ainv = jnp.linalg.inv(A)
    xx = jnp.arange(n, dtype=dt)[:, None] + u[0]
    yy = jnp.arange(m, dtype=dt)[None, :] + u[1]
    # forward transform: f_j = x*ks[j,0] + y*ks[j,1]; mod 1; backward
    f0 = (xx * A[0, 0] + yy * A[0, 1]) % 1.0
    f1 = (xx * A[1, 0] + yy * A[1, 1]) % 1.0
    b0 = f0 * Ainv[0, 0] + f1 * Ainv[0, 1] - rmin[0]
    b1 = f0 * Ainv[1, 0] + f1 * Ainv[1, 1] - rmin[1]
    R0 = b0 * z
    R1 = b1 * z
    i0 = jnp.floor(R0)
    i1 = jnp.floor(R1)
    t0 = R0 - i0
    t1 = R1 - i1
    i0 = i0.astype(jnp.int32)
    i1 = i1.astype(jnp.int32)

    valid = ~jnp.isnan(image)
    val = jnp.where(valid, image, 0.0)
    vw = valid.astype(dt)

    res = jnp.zeros(rsize[0] * rsize[1], dt)
    wsum = jnp.zeros(rsize[0] * rsize[1], dt)
    for li in range(2):
        wx = (1 - t0) if li == 0 else t0
        for lj in range(2):
            wy = (1 - t1) if lj == 0 else t1
            w = wx * wy * vw
            flat = ((i0 + li) * rsize[1] + (i1 + lj)).ravel()
            res = res.at[flat].add((val * w).ravel(), mode="drop")
            wsum = wsum.at[flat].add(w.ravel(), mode="drop")
    return (res / wsum).reshape(rsize), wsum.reshape(rsize)


def unit_cell_average(image, ks, u=None, z=1, return_weights=False,
                      only_generate_func=False):
    """Average an image over all its unit cells (drizzle)
    (unit_cell_averaging.py:132-205). NaN pixels are skipped (mask
    support); unvisited output bins come back NaN (0/0), matching the
    reference's nan padding. `u` is an optional (2, N, M) displacement
    field applied before binning.

    With only_generate_func=True, returns the averaging function
    f(image, u=None) with (ks, z) baked in — the reference's factory
    form (unit_cell_averaging.py:132,153-155,203-204), except that here
    the closure is one cached jit program instead of a fresh numba
    compile per call."""
    ks = np.asarray(ks)
    rmin, rsize = calc_ucell_parameters(ks, z)
    rmin = tuple(rmin)
    rsize = tuple(int(r) for r in rsize)
    ks_d = jnp.asarray(ks)

    def run(image, u=None):
        image = jnp.asarray(image)
        uu = (jnp.zeros((2,) + image.shape, image.dtype) if u is None
              else jnp.asarray(u, image.dtype))
        return _drizzle(image, uu, ks_d, rmin, rsize, int(z))

    if only_generate_func:
        return lambda image, u=None: run(image, u)[0]
    res, wsum = run(image, u)
    if return_weights:
        return res, wsum
    return res


def expand_unitcell(unit_cell_image, ks, shape, z=1, z2=1, u=0,
                    order=3):
    """Re-expand an averaged unit cell to a full image
    (unit_cell_averaging.py:236-249): inverse-map every output pixel
    into the cell and resample (cubic by default, like the reference's
    ndi.map_coordinates)."""
    from ..core import interp
    cell = jnp.nan_to_num(jnp.asarray(unit_cell_image))
    dt = cell.dtype
    rr0, rr1 = jnp.mgrid[: shape[0], : shape[1]]
    rr0 = rr0.astype(dt) / z2
    rr1 = rr1.astype(dt) / z2
    if isinstance(u, (int, float)) and u == 0:
        ux = uy = 0.0
    else:
        u = jnp.asarray(u, dt)
        ux, uy = u[0], u[1]
    rmin, rsize = calc_ucell_parameters(np.asarray(ks), z)
    A = jnp.asarray(ks, dt)
    Ainv = jnp.linalg.inv(A)
    x = rr0 + ux
    y = rr1 + uy
    f0 = (x * A[0, 0] + y * A[0, 1]) % 1.0
    f1 = (x * A[1, 0] + y * A[1, 1]) % 1.0
    X0 = (f0 * Ainv[0, 0] + f1 * Ainv[0, 1] - rmin[0]) * z
    X1 = (f0 * Ainv[1, 0] + f1 * Ainv[1, 1] - rmin[1]) * z
    return interp.map_coordinates(cell, jnp.stack([X0, X1]), order=order,
                                  mode="constant", cval=0.0)
