"""2-D warps through core.interp.map_coordinates vs scipy.ndimage, in
float64: the resampling behind invert_u*, undistort_image and
expand_unitcell. Order 1 is bilinear; order 3 is scipy's prefiltered
cubic B-spline. Smooth, out-of-domain and sawtooth coordinate fields
over both boundary modes the framework uses."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi

from pygpa_tpu.core import interp


def _smooth_case(n, m, amp, seed=0):
    rng = np.random.default_rng(seed)
    img = ndi.gaussian_filter(rng.normal(size=(n, m)), 1.5)
    yy, xx = np.meshgrid(np.arange(n, dtype=float),
                         np.arange(m, dtype=float), indexing="ij")
    u0 = amp * np.sin(2 * np.pi * yy / n) * np.cos(2 * np.pi * xx / m)
    u1 = (amp * np.cos(2 * np.pi * yy / n + 1.0)
          * np.sin(2 * np.pi * xx / m))
    return img, np.stack([yy + u0, xx + u1])


def _in_domain(coords, shape, margin=0.0):
    return ((coords[0] >= margin) & (coords[0] <= shape[0] - 1 - margin)
            & (coords[1] >= margin) & (coords[1] <= shape[1] - 1 - margin))


def _ours(img, coords, order, mode, cval=0.0):
    return np.asarray(interp.map_coordinates(
        jnp.asarray(img), jnp.asarray(coords), order=order, mode=mode,
        cval=cval))


def _compare(img, coords, order, mode, cval):
    """Our warp vs scipy. 'nearest' matches everywhere (order 3 to
    scipy's own 12-sample pre-pad truncation, ~1e-7); for 'constant'
    the two differ only in how a coordinate a fraction of a pixel
    outside the domain is treated (jax blends with cval, scipy cuts),
    so compare in-domain samples and those far outside."""
    mine = _ours(img, coords, order, mode, cval)
    ref = ndi.map_coordinates(img, coords, order=order, mode=mode,
                              cval=cval)
    if mode == "nearest":
        tol = 1e-10 if order == 1 else 1e-6
        assert np.abs(mine - ref).max() < tol
        return
    inside = _in_domain(coords, img.shape)
    far = ~_in_domain(coords, img.shape, margin=-1.0)
    assert np.abs(mine - ref)[inside].max() < 1e-10
    if far.any():
        assert np.all(ref[far] == cval)
        assert np.abs(mine[far] - cval).max() < 1e-12


@pytest.mark.parametrize("shape,amp", [((64, 256), 3.0), ((192, 192), 8.0),
                                       ((128, 384), 20.0)])
@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_bilinear_smooth_warp(shape, amp, mode):
    img, coords = _smooth_case(*shape, amp)
    _compare(img, coords, 1, mode, -3.5)


@pytest.mark.parametrize("shape,amp", [((64, 256), 3.0), ((192, 192), 8.0),
                                       ((128, 384), 20.0)])
@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_cubic_smooth_warp(shape, amp, mode):
    img, coords = _smooth_case(*shape, amp)
    _compare(img, coords, 3, mode, -3.5)


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_warp_boundary_semantics(mode):
    """Sample positions crossing and far beyond every border."""
    rng = np.random.default_rng(3)
    img = ndi.gaussian_filter(rng.normal(size=(96, 128)), 1.0)
    yy, xx = np.meshgrid(np.linspace(-25, 120, 64),
                         np.linspace(-25, 155, 128), indexing="ij")
    coords = np.stack([yy + 2 * np.sin(xx / 40), xx + 2 * np.cos(yy / 40)])
    for order in (1, 3):
        _compare(img, coords, order, mode, 2.5)


def test_warp_1d_coords():
    """A 1-D list of sample points (the shape of a profile cut)."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(256, 256))
    coords = np.stack([np.linspace(-3, 200, 777), np.linspace(200, -3, 777)])
    mine = _ours(img, coords, 1, "nearest")
    assert mine.shape == (777,)
    ref = ndi.map_coordinates(img, coords, order=1, mode="nearest")
    assert np.abs(mine - ref).max() < 1e-10


def test_warp_rect_output_grid():
    """Output grid different from the image grid (the invert_u_overlap
    edge-extended case), both orders."""
    rng = np.random.default_rng(2)
    img = ndi.gaussian_filter(rng.normal(size=(256, 256)), 1.0)
    yy, xx = np.meshgrid(np.arange(40, 168, dtype=float),
                         np.arange(30, 210, dtype=float), indexing="ij")
    coords = np.stack([yy + 4 * np.sin(yy / 20) * np.cos(xx / 25),
                       xx - 5 * np.cos(xx / 30) * np.sin(yy / 17)])
    for order in (1, 3):
        mine = _ours(img, coords, order, "nearest")
        assert mine.shape == yy.shape
        ref = ndi.map_coordinates(img, coords, order=order, mode="nearest")
        assert np.abs(mine - ref).max() < 1e-6


def test_invert_u_matches_scipy_fixed_point():
    """invert_u_overlap at order 1 (its Picard iteration is nothing but
    repeated warps) equals the same fixed-point iteration written with
    scipy.ndimage.map_coordinates."""
    from pygpa_tpu.gpa.pipeline import invert_u_overlap
    n = 128
    yy, xx = np.meshgrid(np.arange(n, dtype=float),
                         np.arange(n, dtype=float), indexing="ij")
    us = np.stack([3.0 * np.sin(2 * np.pi * yy / n),
                   2.0 * np.cos(2 * np.pi * xx / n)])
    mine = np.asarray(invert_u_overlap(jnp.asarray(us), iters=15, order=1))

    def warp(u_it):
        c = np.stack([yy + u_it[0], xx + u_it[1]])
        return np.stack([ndi.map_coordinates(us[i], c, order=1,
                                             mode="nearest")
                         for i in (0, 1)])

    ref = warp(np.zeros_like(us))       # the base sampling at r
    for _ in range(15):
        ref = warp(ref)
    assert np.abs(mine - ref).max() < 1e-10


@pytest.mark.parametrize("mode", ["nearest", "constant"])
@pytest.mark.parametrize("order", [1, 3])
def test_warp_discontinuous_coords(mode, order):
    """Sawtooth (mod-wrapped) coordinate fields — the expand_unitcell
    pattern — need no smoothness: every seam is exact."""
    rng = np.random.default_rng(11)
    img = ndi.gaussian_filter(rng.normal(size=(128, 128)), 1.0)
    yy, xx = np.meshgrid(np.arange(192, dtype=float),
                         np.arange(256, dtype=float), indexing="ij")
    # cell-like wrap: coords jump by ~100 px at each seam
    coords = np.stack([(yy * 0.73 + 0.2 * xx) % 101.0,
                       (xx * 0.61 + 0.1 * yy) % 97.0])
    _compare(img, coords, order, mode, -3.5)


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_prefiltered_coefficients_sampling(mode):
    """Hoisting the prefilter (spline_filter once, then prefilter=False
    with the matching margin — how invert_u resamples one field many
    times) gives the same samples as the one-shot call and scipy."""
    rng = np.random.default_rng(17)
    img = ndi.gaussian_filter(rng.normal(size=(96, 128)), 1.0)
    yy, xx = np.meshgrid(np.linspace(-25, 120, 64),
                         np.linspace(-25, 155, 128), indexing="ij")
    coords = np.stack([yy + 2 * np.sin(xx / 40), xx + 2 * np.cos(yy / 40)])
    mg = interp.NEAREST_MARGIN if mode == "nearest" else 0
    coef = interp.spline_filter(jnp.asarray(img), mode=mode, margin=mg)
    hoisted = np.asarray(interp.map_coordinates(
        coef, jnp.asarray(coords), order=3, mode=mode, cval=2.5,
        prefilter=False, margin=mg))
    oneshot = _ours(img, coords, 3, mode, 2.5)
    assert np.abs(hoisted - oneshot).max() < 1e-12
    _compare(img, coords, 3, mode, 2.5)
