"""Image resampling (map_coordinates).

scipy.ndimage.map_coordinates(order=3) underpins the reference's
distortion inversion, undistortion, and unit-cell expansion
(/root/reference/pyGPA/geometric_phase_analysis.py:256-299,973;
unit_cell_averaging.py:246-248). jax.scipy.ndimage only supports
order<=1, so this module adds a full order=3 path with scipy's exact
semantics: a B-spline prefilter (spline_filter — realized as a
mode-extended pad + short FIR, since the exact IIR inverse decays as
0.268^d and truncating at radius 27 leaves < 1e-15) followed by
B-spline basis sampling from 16 fused gathers; verified to 1e-11
against scipy.ndimage per boundary mode. A prefilter-free Catmull-Rom
variant (cubic='catmull') remains for callers that want one pass.
Everything maps to plain XLA convolutions and gathers (no host
round-trip, vmappable, differentiable).

Modes: 'nearest' (clamp) and 'constant' (cval outside, NaN supported).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy import ndimage as jndi

def _cubic_weights(t):
    """Catmull-Rom weights for taps at offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return (w0, w1, w2, w3)


def _bspline_weights(t):
    """Cubic B-spline basis weights for taps at offsets (-1, 0, 1, 2)
    (to be used on spline_filter'ed coefficients — together they equal
    scipy.ndimage's prefiltered order=3 interpolant)."""
    t2 = t * t
    t3 = t2 * t
    s = 1.0 / 6.0
    w0 = s * (1.0 - 3.0 * t + 3.0 * t2 - t3)
    w1 = s * (4.0 - 6.0 * t2 + 3.0 * t3)
    w2 = s * (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3)
    w3 = s * t3
    return (w0, w1, w2, w3)


# Cubic B-spline prefilter pole z1 = sqrt(3) - 2; the exact IIR
# inverse of the [1/6, 4/6, 1/6] sampling filter is the bi-infinite
# convolution with h[d] = -6 z1 / (1 - z1^2) * z1^|d|. |z1| = 0.268,
# so truncating at radius 27 leaves < 1e-15 relative residual — the
# prefilter becomes a mode-extended pad + short FIR convolution,
# exact for EVERY boundary mode and parallel (no sequential IIR).
_BSPLINE_POLE = 3.0 ** 0.5 - 2.0
_BSPLINE_RADIUS = 27


def _bspline_fir(dtype):
    z = _BSPLINE_POLE
    d = np.abs(np.arange(-_BSPLINE_RADIUS, _BSPLINE_RADIUS + 1))
    return jnp.asarray(-6.0 * z / (1.0 - z * z) * z ** d, dtype)


def _pad_mode(mode):
    # signal extension matching scipy.ndimage's prefilter for each
    # map_coordinates mode (verified vs scipy to 1e-14 interior):
    # 'mirror' reflects about the edge sample (jnp 'reflect'),
    # 'nearest' replicates the edge, 'grid-wrap' tiles, and legacy
    # 'constant' prefilters with MIRROR boundaries (scipy's historical
    # C behavior — zero extension would leak a 0.268^d transient into
    # the interior that scipy does not have).
    return {"mirror": "reflect", "constant": "reflect",
            "nearest": "edge", "grid-wrap": "wrap",
            "wrap": "wrap"}.get(mode, "reflect")


def _pad_axis(x, r, axis, mode):
    """Pad `x` by r along `axis` with the mode's extension, applying
    jnp.pad repeatedly when r exceeds the axis length (jnp 'reflect'
    requires pad < n)."""
    jmode = _pad_mode(mode)
    while r > 0:
        n = x.shape[axis]
        step = min(r, max(n - 1, 1))
        pw = [(0, 0)] * x.ndim
        pw[axis] = (step, step)
        x = jnp.pad(x, pw, mode=jmode)
        r -= step
    return x


# 'nearest'-mode sampling margin reproducing scipy's npad=12 pre-pad
# (_interpolation.py:212-226): 12 off-image px of extended-spline
# evaluation + 1 so the outer B-spline tap at the clamp stays inside
# the extended coefficient array.
NEAREST_MARGIN = 13


def spline_filter(image, mode="mirror", axes=None, margin=0):
    """Cubic B-spline prefilter (scipy.ndimage.spline_filter order=3
    equivalent): returns the coefficient array c with B3 * c = image
    under the mode's boundary extension. Separable over `axes` (all
    axes by default; for stacks pass e.g. axes=(-2, -1)).

    margin > 0 keeps `margin` extra boundary-extension COEFFICIENTS on
    each side of each filtered axis (output length n + 2*margin). The
    'nearest' sampling path needs margin=NEAREST_MARGIN: scipy samples
    the coefficients of the edge-extended signal (its map_coordinates
    pre-pads by npad=12, _interpolation.py:212-226) and only clamps
    coordinates at the PADDED bounds, i.e. 12 px off-image — the
    extended coefficient at -1 is NOT c[0] (clamping taps to a cropped
    array is wrong by up to ~0.2 within 1 px of the border), and
    off-image coordinates evaluate the edge-extended spline out to
    +-12 px before clamping."""
    image = jnp.asarray(image)
    if axes is None:
        axes = tuple(range(image.ndim))
    r = _BSPLINE_RADIUS
    h = _bspline_fir(image.dtype)
    nd = image.ndim
    for ax in axes:
        ax = ax % nd
        x = _pad_axis(image, r + int(margin), ax, mode)
        x = jnp.moveaxis(x, ax, -1)
        lead = x.shape[:-1]
        xf = x.reshape(1, 1, int(np.prod(lead)) if lead else 1,
                       x.shape[-1])
        out = jax.lax.conv_general_dilated(
            xf, h.reshape(1, 1, 1, h.shape[0]),
            window_strides=(1, 1), padding="VALID",
            precision=jax.lax.Precision.HIGHEST)
        image = jnp.moveaxis(out.reshape(*lead, -1), -1, ax)
    return image


@partial(jax.jit, static_argnames=("mode", "cubic"))
def _map_coordinates_cubic(image, coords, cval, mode, cubic="catmull"):
    x, y = coords[0], coords[1]
    n, m = image.shape
    dt = image.dtype
    ix = jnp.floor(x)
    iy = jnp.floor(y)
    tx = (x - ix).astype(dt)
    ty = (y - iy).astype(dt)
    ix = ix.astype(jnp.int32)
    iy = iy.astype(jnp.int32)
    weight_fn = _bspline_weights if cubic == "bspline" else _cubic_weights
    wx = weight_fn(tx)
    wy = weight_fn(ty)

    def _reflect(i, nn):
        # mirror tap reflection (period 2*nn - 2) about the edge samples
        p = 2 * nn - 2
        if p <= 0:
            return jnp.zeros_like(i)
        i = jnp.abs(i) % p
        return jnp.minimum(i, p - i)

    mirror_taps = mode == "constant" and cubic == "bspline"
    flat = image.ravel()
    out = jnp.zeros(x.shape, dt)
    if mode == "constant":
        cval = jnp.asarray(cval, dt)
    for a in range(4):
        xi = ix + (a - 1)
        vx = None
        if mode == "nearest" or mirror_taps:
            xi = _reflect(xi, n) if mirror_taps else jnp.clip(xi, 0, n - 1)
        else:
            vx = (xi >= 0) & (xi < n)
            xi = jnp.clip(xi, 0, n - 1)
        row_acc = jnp.zeros(x.shape, dt)
        for b in range(4):
            yi = iy + (b - 1)
            if mode == "nearest" or mirror_taps:
                yi = _reflect(yi, m) if mirror_taps else jnp.clip(yi, 0, m - 1)
                val = flat[xi * m + yi]
            else:
                vy = (yi >= 0) & (yi < m) & vx
                yi = jnp.clip(yi, 0, m - 1)
                val = jnp.where(vy, flat[xi * m + yi], cval)
            row_acc = row_acc + wy[b] * val
        out = out + wx[a] * row_acc
    if mirror_taps:
        # scipy's legacy 'constant': in-bounds coordinates sample the
        # MIRROR-extended spline; only coordinates outside [0, dim-1]
        # hard-cut to cval
        indom = (x >= 0) & (x <= n - 1) & (y >= 0) & (y <= m - 1)
        out = jnp.where(indom, out, cval)
    return out


def map_coordinates(image, coordinates, order=3, mode="nearest", cval=0.0,
                    cubic="bspline", prefilter=True, margin=0):
    """Sample `image` at fractional `coordinates` (shape (2, ...)).

    order=1 delegates to jax.scipy.ndimage (bilinear); order=3 matches
    scipy.ndimage.map_coordinates: B-spline prefilter (spline_filter)
    + cubic B-spline basis sampling. mode='nearest' clamps to the
    border (the reference's invert_u default,
    geometric_phase_analysis.py:248,283); mode='constant' fills with
    cval outside (undistort_image's final resample and
    expand_unitcell, geometric_phase_analysis.py:973,
    unit_cell_averaging.py:246-248).

    prefilter=False assumes `image` already holds B-spline
    coefficients (scipy semantics) — hoist spline_filter out of
    fixed-point loops that resample one image repeatedly; pass
    `margin` matching the spline_filter(margin=...) used (required
    for scipy-exact 'nearest': margin=NEAREST_MARGIN, see
    spline_filter).
    cubic='catmull' keeps the r1/r2 interpolating Catmull-Rom kernel
    (no prefilter pass; C^1, ~same accuracy on smooth fields).
    """
    image = jnp.asarray(image)
    coordinates = jnp.asarray(coordinates)
    if order <= 1:
        return jndi.map_coordinates(image, list(coordinates), order=order,
                                    mode=mode, cval=cval)
    if mode not in ("nearest", "constant"):
        raise NotImplementedError(f"mode={mode!r} not supported for cubic")
    if cubic == "bspline" and prefilter:
        if mode == "nearest":
            margin = NEAREST_MARGIN
            image = spline_filter(image, mode=mode, margin=margin)
        else:
            image = spline_filter(image, mode=mode)
    if margin:
        # sample the margin-extended coefficients: scipy's 'nearest'
        # clamps coordinates at its npad=12 PRE-PAD bounds, not the
        # domain edge — off-image coordinates up to 12 px out evaluate
        # the edge-extended spline (scipy _interpolation.py:212-226 +
        # the C mapper's NI_EXTEND_NEAREST on the padded array). Clamp
        # at +-(margin-1) and shift into the extended frame; taps for
        # any clamped coordinate span [-margin, n_l+margin] of the
        # logical grid and the outermost one lands in the constant
        # coefficient tail (sub-1e-7, scipy's own truncation level)
        mg = int(margin)
        ext = mg - 1
        n_l = image.shape[0] - 2 * mg
        m_l = image.shape[1] - 2 * mg
        dt = coordinates.dtype
        coordinates = jnp.stack([
            jnp.clip(coordinates[0], -ext, n_l - 1 + ext)
            + jnp.asarray(mg, dt),
            jnp.clip(coordinates[1], -ext, m_l - 1 + ext)
            + jnp.asarray(mg, dt)])
    return _map_coordinates_cubic(image, coordinates, cval, mode,
                                  cubic=cubic)
