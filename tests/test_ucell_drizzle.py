"""Unit-cell drizzle and expansion vs float64 NumPy/scipy oracles.

The drizzle is the reference's serial pixel loop
(unit_cell_averaging.py:164-217): every pixel's position inside the
cell, split over the 2x2 neighbouring bins with bilinear weights. The
expansion inverse-maps every output pixel into the cell and samples it
with scipy.ndimage.map_coordinates (unit_cell_averaging.py:236-249).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi

from pygpa_tpu.lattices import generate_ks
from pygpa_tpu.ucell.averaging import (_drizzle, calc_ucell_parameters,
                                       expand_unitcell, unit_cell_average)


def _cell_positions(shape, ks, z, u=None):
    """(n, m, 2) float64 cell coordinates of every pixel (+u)."""
    rmin, _ = calc_ucell_parameters(ks, z)
    r = np.stack(np.meshgrid(np.arange(shape[0], dtype=float),
                             np.arange(shape[1], dtype=float),
                             indexing="ij"), -1)
    if u is not None:
        r = r + np.moveaxis(u, 0, -1)
    frac = (r @ ks.T) % 1.0
    return (frac @ np.linalg.inv(ks).T - rmin) * z


def _numpy_drizzle(img, ks, z, u=None):
    _, rsize = calc_ucell_parameters(ks, z)
    R = _cell_positions(img.shape, ks, z, u)
    i0 = np.floor(R).astype(np.int64)
    t = R - i0
    valid = ~np.isnan(img)
    val = np.where(valid, img, 0.0)
    res = np.zeros(rsize)
    wsum = np.zeros(rsize)
    for li in (0, 1):
        for lj in (0, 1):
            w = ((t[..., 0] if li else 1 - t[..., 0])
                 * (t[..., 1] if lj else 1 - t[..., 1]) * valid)
            a = i0[..., 0] + li
            b = i0[..., 1] + lj
            ok = (a >= 0) & (a < rsize[0]) & (b >= 0) & (b < rsize[1])
            np.add.at(res, (a[ok], b[ok]), (val * w)[ok])
            np.add.at(wsum, (a[ok], b[ok]), w[ok])
    return res, wsum


@pytest.fixture(scope="module")
def drizzle_case():
    rng = np.random.default_rng(1)
    ks2 = np.asarray(generate_ks(0.06, 9.0))[:2]
    img = rng.normal(size=(160, 256))
    img[10:14, 40:60] = np.nan          # masked region
    u = 0.8 * rng.normal(size=(2,) + img.shape)
    return ks2, 2, img, u


@pytest.mark.parametrize("with_u", [False, True])
def test_drizzle_matches_numpy(drizzle_case, with_u):
    ks2, z, img, u = drizzle_case
    uu = u if with_u else None
    rmin, rsize = calc_ucell_parameters(ks2, z)
    res, wsum = _drizzle(jnp.asarray(img),
                         jnp.asarray(u if with_u else np.zeros_like(u)),
                         jnp.asarray(ks2), tuple(rmin),
                         tuple(int(r) for r in rsize), z)
    res_r, w_r = _numpy_drizzle(img, ks2, z, uu)
    assert ((np.asarray(wsum) > 0) == (w_r > 0)).all()
    np.testing.assert_allclose(np.asarray(wsum), w_r, rtol=1e-10,
                               atol=1e-12)
    ok = w_r > 1e-9
    np.testing.assert_allclose(np.asarray(res)[ok], res_r[ok] / w_r[ok],
                               rtol=1e-9, atol=1e-12)
    # the public entry point is the same program
    pub = unit_cell_average(img, ks2, u=uu, z=z)
    np.testing.assert_array_equal(np.asarray(pub)[ok],
                                  np.asarray(res)[ok])


def test_drizzle_nan_mask(drizzle_case):
    """NaN pixels contribute neither value nor weight; an all-NaN image
    leaves every bin unvisited (NaN)."""
    ks2, z, img, _ = drizzle_case
    res, w = unit_cell_average(np.full_like(img, np.nan), ks2, z=z,
                               return_weights=True)
    assert float(np.abs(np.asarray(w)).max()) == 0.0
    assert np.isnan(np.asarray(res)).all()


@pytest.fixture(scope="module")
def expand_case():
    rng = np.random.default_rng(0)
    ks2 = np.asarray(generate_ks(0.05, 7.0))[:2]
    z = 2
    _, rsize = calc_ucell_parameters(ks2, z)
    cell = rng.normal(size=rsize)  # worst case: white-noise cell
    shape = (192, 256)
    u = 0.5 * rng.normal(size=(2,) + shape)
    return ks2, z, cell, shape, u


def _expand_ref(cell, ks, shape, z, z2=1, u=None, order=3):
    rmin, _ = calc_ucell_parameters(ks, z)
    r = np.stack(np.meshgrid(np.arange(shape[0], dtype=float),
                             np.arange(shape[1], dtype=float),
                             indexing="ij"), -1) / z2
    if u is not None:
        r = r + np.moveaxis(u, 0, -1)
    X = (((r @ ks.T) % 1.0) @ np.linalg.inv(ks).T - rmin) * z
    return ndi.map_coordinates(np.nan_to_num(cell), np.moveaxis(X, -1, 0),
                               order=order, mode="constant", cval=0.0), X


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("with_u", [False, True])
def test_expand_matches_scipy(expand_case, order, with_u):
    ks2, z, cell, shape, u = expand_case
    uu = u if with_u else None
    mine = np.asarray(expand_unitcell(jnp.asarray(cell), ks2, shape, z=z,
                                      u=(0 if uu is None else uu),
                                      order=order))
    ref, X = _expand_ref(cell, ks2, shape, z, u=uu, order=order)
    # in-domain samples (a coordinate a fraction of a pixel outside the
    # cell is blended with cval by jax's bilinear, cut by scipy)
    inside = ((X[..., 0] >= 0) & (X[..., 0] <= cell.shape[0] - 1)
              & (X[..., 1] >= 0) & (X[..., 1] <= cell.shape[1] - 1))
    assert inside.mean() > 0.5
    assert np.abs(mine - ref)[inside].max() < 1e-9


def test_expand_f32_accuracy(expand_case):
    """Float32 expansion stays within coordinate rounding of the
    float64 oracle."""
    ks2, z, cell, shape, _ = expand_case
    ref, X = _expand_ref(cell, ks2, shape, z)
    mine = np.asarray(expand_unitcell(jnp.asarray(cell.astype(np.float32)),
                                      ks2, shape, z=z, u=0, order=3))
    assert mine.dtype == np.float32
    inside = ((X[..., 0] >= 1) & (X[..., 0] <= cell.shape[0] - 2)
              & (X[..., 1] >= 1) & (X[..., 1] <= cell.shape[1] - 2))
    assert np.abs(mine - ref)[inside].max() < 1e-3


def test_expand_z2_supersampling(expand_case):
    ks2, z, cell, shape, _ = expand_case
    mine = np.asarray(expand_unitcell(jnp.asarray(cell), ks2, shape, z=z,
                                      z2=2, u=0, order=3))
    ref, X = _expand_ref(cell, ks2, shape, z, z2=2)
    inside = ((X[..., 0] >= 0) & (X[..., 0] <= cell.shape[0] - 1)
              & (X[..., 1] >= 0) & (X[..., 1] <= cell.shape[1] - 1))
    assert np.abs(mine - ref)[inside].max() < 1e-9
