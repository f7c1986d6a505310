"""Core numerics: DCT vs scipy, Moisan decomposition, math utilities,
interpolation vs scipy.ndimage."""
import numpy as np
import scipy.ndimage as ndi
from scipy.fft import dctn, idctn
import jax.numpy as jnp
import pytest

from pygpa_tpu.core.fourier import (dct2n, idct2n, moisan_per,
                                    fourier_gaussian_multiplier,
                                    gaussian_filter_fft)
from pygpa_tpu.core.mathtools import (wrap_to_pi, periodic_average,
                                      periodic_difference, fit_plane,
                                      standardize_ks,
                                      remove_negative_duplicates)
from pygpa_tpu.core import interp


def test_dct_matches_scipy():
    rng = np.random.default_rng(0)
    for shape in [(16, 16), (17, 24), (128, 96), (33, 1)]:
        x = rng.normal(size=shape)
        assert np.allclose(np.asarray(dct2n(jnp.asarray(x))), dctn(x),
                           atol=1e-10 * max(shape))
        assert np.allclose(np.asarray(idct2n(jnp.asarray(dctn(x)))),
                           idctn(dctn(x)), atol=1e-12 * max(shape))
        assert np.allclose(np.asarray(idct2n(dct2n(jnp.asarray(x)))), x,
                           atol=1e-12 * max(shape))


def test_fourier_gaussian_matches_scipy():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 48))
    X = np.fft.fft2(x)
    ref = ndi.fourier_gaussian(X, sigma=7.5)
    mine = np.asarray(fourier_gaussian_multiplier(x.shape, 7.5,
                                                  jnp.float64)) * X
    assert np.allclose(mine, ref)


def test_moisan_per_reconstructs_and_removes_cross():
    rng = np.random.default_rng(2)
    # strong boundary mismatch: a ramp
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img = 0.3 * xx + np.cos(2 * np.pi * 0.2 * yy) + 0.1 * rng.normal(size=(n, n))
    p, s = [np.asarray(z) for z in moisan_per(jnp.asarray(img))]
    assert np.allclose(p + s, img, atol=1e-10)
    # the periodic component's DFT should have far less energy on the
    # cross (axis) lines than the raw DFT
    raw = np.abs(np.fft.fft2(img))
    per = np.abs(np.fft.fft2(p))
    cross_raw = raw[0, 5:-5].sum() + raw[5:-5, 0].sum()
    cross_per = per[0, 5:-5].sum() + per[5:-5, 0].sum()
    assert cross_per < 0.2 * cross_raw
    # and the wraparound jumps of p are tiny compared to the raw image
    assert np.abs(p[-1] - p[0]).mean() < 0.05 * np.abs(img[-1]
                                                       - img[0]).mean()


def test_gaussian_filter_fft_interior_matches_scipy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(96, 96))
    mine = np.asarray(gaussian_filter_fft(jnp.asarray(x), 3.0))
    ref = ndi.gaussian_filter(x, 3.0)
    # circular vs reflect boundaries: compare interior (scipy also
    # truncates its kernel at 4 sigma, hence the 1e-4 tolerance)
    assert np.allclose(mine[16:-16, 16:-16], ref[16:-16, 16:-16],
                       atol=1e-4)
    # exact match against the untruncated periodic filter
    ref_wrap = ndi.gaussian_filter(x, 3.0, mode="wrap", truncate=12.0)
    assert np.allclose(mine, ref_wrap, atol=1e-12)


def test_wrap_and_periodic():
    x = np.linspace(-10, 10, 101)
    assert np.allclose(np.asarray(wrap_to_pi(x)),
                       (x + np.pi) % (2 * np.pi) - np.pi)
    a = np.array([359.0, 1.0])
    pa = np.asarray(periodic_average(a, period=360))
    assert np.isclose(np.asarray(periodic_difference(pa, 0.0, period=360)),
                      0.0, atol=1e-8)
    assert np.isclose(np.asarray(periodic_difference(350.0, 10.0,
                                                     period=360)), -20.0)


def test_fit_plane_huber():
    rng = np.random.default_rng(4)
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img = 0.3 * xx - 0.7 * yy + 2.0 + 0.01 * rng.normal(size=(n, n))
    # salt some strong outliers: huber should shrug them off
    img[::13, ::17] += 50
    p = np.asarray(fit_plane(jnp.asarray(img)))
    assert np.allclose(p, [0.3, -0.7, 2.0], atol=2e-2)


def test_standardize_ks():
    ks = np.array([[1.0, 0.1], [-1.0, -0.1], [0.5, 0.8], [-0.4, 0.9]])
    out = standardize_ks(ks)
    assert out.shape == (3, 2)
    angles = np.arctan2(out[:, 1], out[:, 0])
    assert np.all(np.diff(angles) > 0)  # sorted by angle
    nn = remove_negative_duplicates(ks)
    assert len(nn) == 3  # +/- pair collapsed


@pytest.mark.parametrize("order,mode", [(1, "nearest"), (3, "nearest"),
                                        (1, "constant"), (3, "constant")])
def test_map_coordinates_vs_scipy(order, mode):
    rng = np.random.default_rng(5)
    img = ndi.gaussian_filter(rng.normal(size=(40, 40)), 2.0)
    coords = np.stack([rng.uniform(-3, 42, size=(25, 25)),
                       rng.uniform(-3, 42, size=(25, 25))])
    mine = np.asarray(interp.map_coordinates(jnp.asarray(img),
                                             jnp.asarray(coords),
                                             order=order, mode=mode,
                                             cval=0.0))
    ref = ndi.map_coordinates(img, coords, order=order, mode=mode,
                              cval=0.0)
    if order == 1:
        if mode == "constant":
            # jax blends with cval for fractionally-outside points
            # where scipy hard-cuts; compare in-domain points
            indom = ((coords[0] >= 0) & (coords[0] <= 39)
                     & (coords[1] >= 0) & (coords[1] <= 39))
            assert np.allclose(mine[indom], ref[indom], atol=1e-10)
        else:
            assert np.allclose(mine, ref, atol=1e-10)
    else:
        # prefiltered B-spline: EXACT scipy semantics in the interior
        # (the border rim differs only in the out-of-range coordinate
        # convention; prefilter BCs are matched per mode)
        inside = ((coords[0] > 2) & (coords[0] < 37)
                  & (coords[1] > 2) & (coords[1] < 37))
        err = np.abs(mine - ref)[inside]
        assert err.max() < 1e-10
        # the Catmull-Rom fast path stays available and close on
        # smooth images
        cr = np.asarray(interp.map_coordinates(
            jnp.asarray(img), jnp.asarray(coords), order=3, mode=mode,
            cval=0.0, cubic="catmull"))
        assert np.abs(cr - ref)[inside].max() < 0.05 * np.abs(img).max()


def test_spline_filter_matches_scipy():
    """Exact equivalence of the pad+FIR prefilter with scipy's IIR
    solve, including images smaller than the FIR radius (repeated
    symmetric padding lands each reflection on a symmetry point of the
    infinite extension). Only 'mirror' is compared directly:
    scipy.ndimage.spline_filter's standalone 'nearest' uses a legacy
    initial-condition convention that map_coordinates itself does NOT
    use — the nearest contract is pinned end-to-end in
    test_map_coordinates_nearest_exact_with_border instead."""
    rng = np.random.default_rng(11)
    for shape in [(64, 53), (9, 7), (40, 3)]:
        img = rng.standard_normal(shape)
        ref = ndi.spline_filter(img, order=3, mode="mirror")
        got = np.asarray(interp.spline_filter(jnp.asarray(img),
                                              mode="mirror"))
        assert np.abs(got - ref).max() < 1e-11, shape


def test_map_coordinates_nearest_exact_with_border():
    """mode='nearest' matches scipy everywhere in-domain (prefilter
    extension = edge replication, sampled with a margin-extended
    coefficient array — clamping taps to cropped coefficients is
    wrong by ~0.2 within 1 px of the border). Tolerance is scipy's
    OWN truncation: it pre-pads by only 12 samples
    (_interpolation.py:212-226), leaving ~|z1|^12 ~ 1e-7 boundary
    error vs the exact edge-extended spline computed here."""
    rng = np.random.default_rng(12)
    img = rng.standard_normal((32, 45))
    coords = np.stack([rng.uniform(0, 31, (300,)),
                       rng.uniform(0, 44, (300,))])
    ref = ndi.map_coordinates(img, coords, order=3, mode="nearest")
    got = np.asarray(interp.map_coordinates(jnp.asarray(img),
                                            jnp.asarray(coords),
                                            order=3, mode="nearest"))
    assert np.abs(got - ref).max() < 1e-6
    # out-of-domain coordinates match scipy's semantics too: the
    # edge-extended spline is evaluated out to scipy's npad=12 pre-pad
    # and clamped there (NEAREST_MARGIN) — formerly the one documented
    # deviation, now scipy-exact to its own truncation level
    oob = np.stack([rng.uniform(-20, 51, (2000,)),
                    rng.uniform(-20, 64, (2000,))])
    ref2 = ndi.map_coordinates(img, oob, order=3, mode="nearest")
    got2 = np.asarray(interp.map_coordinates(jnp.asarray(img),
                                             jnp.asarray(oob),
                                             order=3, mode="nearest"))
    assert np.abs(got2 - ref2).max() < 1e-6


def test_map_coordinates_cubic_accuracy():
    # cubic should beat linear by an order of magnitude on a smooth field
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img = np.cos(2 * np.pi * 0.1 * xx) * np.cos(2 * np.pi * 0.08 * yy)
    rng = np.random.default_rng(6)
    pts = np.stack([rng.uniform(5, n - 5, 500), rng.uniform(5, n - 5, 500)])
    true = np.cos(2 * np.pi * 0.1 * pts[0]) * np.cos(2 * np.pi * 0.08 * pts[1])
    lin = np.asarray(interp.map_coordinates(jnp.asarray(img),
                                            jnp.asarray(pts), order=1))
    cub = np.asarray(interp.map_coordinates(jnp.asarray(img),
                                            jnp.asarray(pts), order=3))
    assert np.abs(cub - true).max() < 0.2 * np.abs(lin - true).max()


@pytest.mark.parametrize("n", [1024, 2048])
def test_dct_large_axes_match_scipy(n):
    """The production DCT route at unwrap-solver sizes (both axes,
    forward and inverse) matches scipy in float64."""
    from scipy.fft import dct as sdct
    from pygpa_tpu.core.fourier import dct2_1d, idct2_1d
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, n))
    assert np.allclose(np.asarray(dct2_1d(jnp.asarray(x))),
                       sdct(x, type=2, axis=-1), atol=1e-9)
    y = sdct(x, type=2, axis=-1)
    assert np.allclose(np.asarray(idct2_1d(jnp.asarray(y))), x,
                       atol=1e-11)
    x2 = rng.normal(size=(n, 136))
    assert np.allclose(np.asarray(dct2n(jnp.asarray(x2))), dctn(x2),
                       atol=1e-9 * n)
    assert np.allclose(np.asarray(idct2n(jnp.asarray(dctn(x2)))), x2,
                       atol=1e-11 * n)
