"""Windowed-Fourier-Ridge sweep — the pipeline's hot loop.

The reference sweeps a grid of candidate reference vectors w around
each Bragg peak k; for every w it modulates the image, runs a forward
+ inverse FFT with a Gaussian bandpass, and keeps, per pixel, the w
with the largest lock-in amplitude (optwfr2 / wfr2_grad_opt,
/root/reference/pyGPA/geometric_phase_analysis.py:669-686,763-813 —
HOT LOOP #1; CuPy mirror cuGPA.py:41-133). That costs 2 full-size
complex FFTs per candidate plus per-w plane-wave construction and
boolean fancy-indexing updates.

Single-FFT formulation (see ops/lockin.py for the identity):

  M_w(r) = IFFT[ F(q) * G_sigma(q + w) ],   F = FFT(image)  (once!)

 - ONE forward FFT for the whole sweep; per candidate only a separable
   analytic Gaussian, a fused complex multiply, and one inverse FFT.
 - M_w is the lock-in *demodulated by w*, so the running per-pixel
   argmax needs no per-w rebasing phase at all: the winner is rebased
   to k once at the end with a single plane wave (the per-w factor
   e^{-2 pi i (w-k).r} of the reference equals e^{-2 pi i w r} *
   e^{+2 pi i k r}, and the first factor is already inside M_w).
 - the phase gradient (wfr2_grad_opt) likewise needs only a constant
   -2 pi k correction after the sweep, since grad(-angle M_w) =
   grad(-angle L_w) + 2 pi w; the reference's trailing
   wrapToPi(2g)/2 (geometric_phase_analysis.py:812) maps both
   formulations to the same representative.
 - candidates are processed in chunks via lax.scan with a batched
   inverse FFT (or, when the bandpass window is small, via the zoom
   matmul sweep below); the carry holds (best |.|^2, best complex,
   best index, best grad), all updated with jnp.where — the jnp
   analogue of the cupy running-max (cuGPA.py:74-76).

Boundary semantics: both formulations see the circular wrap-around of
the Gaussian window (both are FFT-circular); within ~4 sigma of the
image borders the wrapped tail enters with phase e^{2 pi i w N} here
versus 1 in the reference — two equally artifactual conventions.
Interior values agree to float precision (tests/test_lockin_wfr.py);
pipelines mask a 2-sigma rim regardless (extract_displacement_field's
weight mask, geometric_phase_analysis.py:923-926).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..core.mathtools import wrap_to_pi


def _np_gradient_2d(ph):
    """np.gradient-compatible (first-order edges, central interior)
    gradients along the last two axes. Returns (d_axis0, d_axis1)."""
    gx = jnp.concatenate([
        ph[..., 1:2, :] - ph[..., 0:1, :],
        (ph[..., 2:, :] - ph[..., :-2, :]) * 0.5,
        ph[..., -1:, :] - ph[..., -2:-1, :],
    ], axis=-2)
    gy = jnp.concatenate([
        ph[..., :, 1:2] - ph[..., :, 0:1],
        (ph[..., :, 2:] - ph[..., :, :-2]) * 0.5,
        ph[..., :, -1:] - ph[..., :, -2:-1],
    ], axis=-1)
    return gx, gy


def _shifted_gaussians(shape, ws, sigma, dtype):
    """Separable Gaussian bandpass factors G(q + w) for a chunk of ws.
    Returns (gx (C, N), gy (C, M))."""
    fx = jnp.fft.fftfreq(shape[0]).astype(dtype)
    fy = jnp.fft.fftfreq(shape[1]).astype(dtype)
    s2 = jnp.asarray(2.0 * np.pi ** 2 * sigma ** 2, dtype)
    gx = jnp.exp(-s2 * (fx[None, :] + ws[:, 0:1]) ** 2)
    gy = jnp.exp(-s2 * (fy[None, :] + ws[:, 1:2]) ** 2)
    return gx, gy


@partial(jax.jit, static_argnames=("sigma", "with_grad", "chunk"))
def _wfr_sweep_chunked(spectrum, wlist, sigma, with_grad, chunk):
    n, m = spectrum.shape
    rdt = jnp.zeros((), spectrum.real.dtype).dtype
    P = wlist.shape[0]
    pad = (-P) % chunk
    # sentinel candidates far outside the band: bandpass response == 0,
    # strict '>' keeps them from ever winning.
    wpad = jnp.full((pad, 2), 1e3, wlist.dtype)
    wl = jnp.concatenate([wlist.astype(rdt), wpad.astype(rdt)])
    nchunks = (P + pad) // chunk
    wl = wl.reshape(nchunks, chunk, 2)

    def body(carry, xs):
        best_absq, best_lockin, best_idx, best_grad = carry
        ws, base_idx = xs
        gx, gy = _shifted_gaussians((n, m), ws, sigma, rdt)
        G = gx[:, :, None] * gy[:, None, :]
        Mw = jnp.fft.ifft2(spectrum[None] * G.astype(spectrum.dtype))
        absq = Mw.real * Mw.real + Mw.imag * Mw.imag
        if with_grad:
            ph = -jnp.arctan2(Mw.imag, Mw.real)
            ggx, ggy = _np_gradient_2d(ph)
        # reduce the chunk with an unrolled strict-'>' where-tournament:
        # first max wins (the reference's sequential update order)
        for i in range(ws.shape[0]):
            better = absq[i] > best_absq
            best_absq = jnp.where(better, absq[i], best_absq)
            best_lockin = jnp.where(better, Mw[i], best_lockin)
            best_idx = jnp.where(better, base_idx + i, best_idx)
            if with_grad:
                gi = jnp.stack([ggx[i], ggy[i]], axis=-1)
                best_grad = jnp.where(better[..., None], gi, best_grad)
        return (best_absq, best_lockin, best_idx, best_grad), None

    base_idx = (jnp.arange(nchunks) * chunk).astype(jnp.int32)
    init = (jnp.zeros((n, m), rdt),
            jnp.zeros((n, m), spectrum.dtype),
            jnp.zeros((n, m), jnp.int32),
            jnp.zeros((n, m, 2), rdt) if with_grad else jnp.zeros((0,), rdt))
    (best_absq, best_lockin, best_idx, best_grad), _ = jax.lax.scan(
        body, init, (wl, base_idx))
    return best_absq, best_lockin, best_idx, best_grad


@partial(jax.jit, static_argnames=("sigma", "with_grad", "dk"))
def _wfr_sweep_sequential(spectrum, wlist, sigma, with_grad, dk):
    """Sequential variant with the wfr4 k-continuity constraint
    (geometric_phase_analysis.py:839-862): a candidate only wins if it
    also lies within 2*sqrt(2)*dk of the pixel's current winner."""
    n, m = spectrum.shape
    rdt = jnp.zeros((), spectrum.real.dtype).dtype
    wl = wlist.astype(rdt)

    def body(carry, xs):
        best_absq, best_lockin, best_w, best_idx, best_grad = carry
        w, idx = xs
        gx, gy = _shifted_gaussians((n, m), w[None], sigma, rdt)
        G = gx[0, :, None] * gy[0, None, :]
        Mw = jnp.fft.ifft2(spectrum * G.astype(spectrum.dtype))
        absq = Mw.real * Mw.real + Mw.imag * Mw.imag
        t = absq > best_absq
        if dk is not None:
            dist2 = ((best_w[..., 0] - w[0]) ** 2
                     + (best_w[..., 1] - w[1]) ** 2)
            t = t & (dist2 < 8.0 * dk * dk)
        best_absq = jnp.where(t, absq, best_absq)
        best_lockin = jnp.where(t, Mw, best_lockin)
        best_w = jnp.where(t[..., None], w, best_w)
        best_idx = jnp.where(t, idx.astype(jnp.int32), best_idx)
        if with_grad:
            ph = -jnp.arctan2(Mw.imag, Mw.real)
            ggx, ggy = _np_gradient_2d(ph)
            gi = jnp.stack([ggx, ggy], axis=-1)
            best_grad = jnp.where(t[..., None], gi, best_grad)
        return (best_absq, best_lockin, best_w, best_idx,
                best_grad), None

    init_w = jnp.broadcast_to(wl[0], (n, m, 2))
    init = (jnp.zeros((n, m), rdt), jnp.zeros((n, m), spectrum.dtype),
            init_w, jnp.zeros((n, m), jnp.int32),
            jnp.zeros((n, m, 2), rdt) if with_grad
            else jnp.zeros((0,), rdt))
    (best_absq, best_lockin, best_w, best_idx, best_grad), _ = \
        jax.lax.scan(body, init, (wl, jnp.arange(wl.shape[0])))
    return best_absq, best_lockin, best_w, best_idx, best_grad


@partial(jax.jit, static_argnames=("sigma", "with_grad", "dk"))
def _wfr_sweep_sequential_zoom(spectrum, wlist, idx0, idx1, sigma,
                               with_grad, dk):
    """Band-limited (zoom matmul) form of the wfr4 continuity sweep:
    per candidate the full-resolution demodulated lock-in comes from
    two skinny DFT matmuls on the cropped spectrum window instead of a
    full-size inverse FFT (the sequential continuity gate forces a
    per-candidate scan, but each step is two small matmuls). The
    continuity update semantics are identical to
    _wfr_sweep_sequential; grads are analytic derivatives of the
    band-limited interpolant: the row-derivative window
    (2 pi i f0) * S and the column-derivative basis (2 pi i f1) * A1
    give dM/d(row), dM/d(col), which agree with the reference's
    np.gradient of the winner phase to O(h^2) on the smooth
    demodulated phase."""
    n, m = spectrum.shape
    rdt = jnp.zeros((), spectrum.real.dtype).dtype
    wl = wlist.astype(rdt)
    S = jnp.take(jnp.take(spectrum, idx0, axis=0), idx1, axis=1)
    scale = jnp.asarray(1.0 / (n * m), rdt)
    Sr, Si = S.real * scale, S.imag * scale
    A0c, A0s = _zoom_basis(n, idx0, rdt)
    A1c, A1s = _zoom_basis(m, idx1, rdt)
    f0 = jnp.where(idx0 < n // 2 + n % 2, idx0, idx0 - n).astype(rdt) / n
    f1 = jnp.where(idx1 < m // 2 + m % 2, idx1, idx1 - m).astype(rdt) / m
    s2 = jnp.asarray(2.0 * np.pi ** 2 * sigma ** 2, rdt)
    hi = _ZOOM_PRECISION
    if with_grad:
        tpf0 = (2 * jnp.pi) * f0
        tpf1 = (2 * jnp.pi) * f1
        S2r = -tpf0[:, None] * Si
        S2i = tpf0[:, None] * Sr
        A1yc = -A1s * tpf1[None, :]
        A1ys = A1c * tpf1[None, :]

    def mm(a, b):
        return jnp.einsum("rw,wv->rv", a, b, precision=hi)

    def mmT(a, b):
        return jnp.einsum("rv,sv->rs", a, b, precision=hi)

    def stage(gx, gy, xr, xi):
        Swr = gx[:, None] * xr * gy[None, :]
        Swi = gx[:, None] * xi * gy[None, :]
        Tr = mm(A0c, Swr) - mm(A0s, Swi)
        Ti = mm(A0c, Swi) + mm(A0s, Swr)
        return Tr, Ti

    def body(carry, xs):
        best_absq, best_r, best_i, best_w, best_idx, best_grad = carry
        w, idx = xs
        gx = jnp.exp(-s2 * (f0 + w[0]) ** 2)
        gy = jnp.exp(-s2 * (f1 + w[1]) ** 2)
        Tr, Ti = stage(gx, gy, Sr, Si)
        Mr = mmT(Tr, A1c) - mmT(Ti, A1s)
        Mi = mmT(Tr, A1s) + mmT(Ti, A1c)
        absq = Mr * Mr + Mi * Mi
        t = absq > best_absq
        if dk is not None:
            dist2 = ((best_w[..., 0] - w[0]) ** 2
                     + (best_w[..., 1] - w[1]) ** 2)
            t = t & (dist2 < 8.0 * dk * dk)
        best_absq = jnp.where(t, absq, best_absq)
        best_r = jnp.where(t, Mr, best_r)
        best_i = jnp.where(t, Mi, best_i)
        best_w = jnp.where(t[..., None], w, best_w)
        best_idx = jnp.where(t, idx.astype(jnp.int32), best_idx)
        if with_grad:
            Txr, Txi = stage(gx, gy, S2r, S2i)
            Mxr = mmT(Txr, A1c) - mmT(Txi, A1s)
            Mxi = mmT(Txr, A1s) + mmT(Txi, A1c)
            Myr = mmT(Tr, A1yc) - mmT(Ti, A1ys)
            Myi = mmT(Tr, A1ys) + mmT(Ti, A1yc)
            den = jnp.maximum(absq, jnp.asarray(1e-30, rdt))
            gi = jnp.stack([(Mi * Mxr - Mr * Mxi) / den,
                            (Mi * Myr - Mr * Myi) / den], axis=-1)
            best_grad = jnp.where(t[..., None], gi, best_grad)
        return (best_absq, best_r, best_i, best_w, best_idx,
                best_grad), None

    init_w = jnp.broadcast_to(wl[0], (n, m, 2))
    init = (jnp.zeros((n, m), rdt), jnp.zeros((n, m), rdt),
            jnp.zeros((n, m), rdt), init_w,
            jnp.zeros((n, m), jnp.int32),
            jnp.zeros((n, m, 2), rdt) if with_grad
            else jnp.zeros((0,), rdt))
    (best_absq, best_r, best_i, best_w, best_idx, best_grad), _ = \
        jax.lax.scan(body, init, (wl, jnp.arange(wl.shape[0])))
    return (best_absq, jax.lax.complex(best_r, best_i), best_w,
            best_idx, best_grad)


# Matmul precision of the zoom sweep's DFT contractions: float32-exact.
# On an H100, TF32 (Precision.HIGH/DEFAULT there) moves the 4096^2
# bench gates to 0.027 px raw / 0.025 px dc-free (> 0.002 / 0.0012).
# The bf16x6 dot algorithm is as accurate and faster on one card, but
# inside shard_map the algorithm attribute is dropped and the
# row-sharded sweep silently ran in TF32, so HIGHEST everywhere.
_ZOOM_PRECISION = jax.lax.Precision.HIGHEST


def _zoom_window(n, center_bin, half_need):
    """Window bin indices (mod n) around center_bin; returns int32
    index vector of length W (host numpy)."""
    W = int(half_need) * 2
    idx = (center_bin - W // 2 + np.arange(W)) % n
    return idx.astype(np.int32)


# -ln(G) at the zoom-window edge. 22 -> G ~ 3e-10 (below f32
# resolution of the passband).
_GAUSS_CUT = 22.0


def _plan_zoom(shape, wlist, sigma, *, pad_bins=6, align=64):
    """Plan the band-limited (zoom) sweep: the Gaussian bandpass
    G(q + w) confines every candidate's spectrum to a small window
    around -mean(w); if that window (plus the candidate spread and a
    safety margin) is much smaller than the image, the per-candidate
    inverse FFT can be computed as two skinny DFT matmuls instead of a
    full-size FFT. Returns (idx0, idx1) window index vectors or None
    when the window would not be worthwhile."""
    n, m = shape
    f_band = np.sqrt(_GAUSS_CUT / 2.0) / (np.pi * sigma)
    w = np.asarray(wlist, np.float64)
    c0 = int(np.round(-np.mean(w[:, 0]) * n))
    c1 = int(np.round(-np.mean(w[:, 1]) * m))
    ext0 = np.max(np.abs(-w[:, 0] * n - c0)) if len(w) else 0.0
    ext1 = np.max(np.abs(-w[:, 1] * m - c1)) if len(w) else 0.0
    need0 = int(np.ceil(f_band * n + ext0)) + pad_bins
    need1 = int(np.ceil(f_band * m + ext1)) + pad_bins
    # round the half-width up so W = 2*half is a multiple of `align`
    # (widening is exact: the extra bins carry ~zero Gaussian weight,
    # and the Bragg peaks of one image then share window shapes)
    half0 = -(-need0 // (align // 2)) * (align // 2)
    half1 = -(-need1 // (align // 2)) * (align // 2)
    if 2 * half0 > 0.7 * n or 2 * half1 > 0.7 * m:
        return None
    return _zoom_window(n, c0, half0), _zoom_window(m, c1, half1)


def _zoom_basis(n, idx, dtype):
    """cos/sin of the inverse-DFT submatrix e^{2 pi i r idx / n} (n, W),
    computed in-graph with integer mod so large arguments stay exact."""
    r = jnp.arange(n, dtype=jnp.int32)[:, None]
    ph = (r * idx[None, :]) % n
    ang = (2 * jnp.pi / n) * ph.astype(dtype)
    return jnp.cos(ang), jnp.sin(ang)


@partial(jax.jit, static_argnames=("sigma", "with_grad", "chunk"))
def _wfr_sweep_zoom(spectrum, wlist, idx0, idx1, sigma, with_grad,
                    chunk):
    """Band-limited sweep: crop the spectrum to the (W0, W1) window all
    candidate bandpasses live in, then per candidate compute the
    full-resolution demodulated lock-in M_w as two real-decomposed
    skinny matmuls instead of a full-size inverse FFT. Identical
    values to _wfr_sweep_chunked up to the sub-float32 window
    truncation (G < 3e-10 outside) and matmul rounding."""
    n, m = spectrum.shape
    rdt = jnp.zeros((), spectrum.real.dtype).dtype
    P = wlist.shape[0]
    pad = (-P) % chunk
    wl = jnp.concatenate([wlist.astype(rdt),
                          jnp.full((pad, 2), 1e3, rdt)])
    nchunks = (P + pad) // chunk
    wl = wl.reshape(nchunks, chunk, 2)

    S = jnp.take(jnp.take(spectrum, idx0, axis=0), idx1, axis=1)
    Sr, Si = S.real, S.imag
    A0c, A0s = _zoom_basis(n, idx0, rdt)   # (n, W0)
    A1c, A1s = _zoom_basis(m, idx1, rdt)   # (m, W1)
    scale = jnp.asarray(1.0 / (n * m), rdt)
    # window frequencies (cycles/px) for the shifted Gaussian
    f0 = jnp.where(idx0 < n // 2 + n % 2, idx0, idx0 - n).astype(rdt) / n
    f1 = jnp.where(idx1 < m // 2 + m % 2, idx1, idx1 - m).astype(rdt) / m
    s2 = jnp.asarray(2.0 * np.pi ** 2 * sigma ** 2, rdt)
    hi = _ZOOM_PRECISION

    def mm(a, b):
        return jnp.einsum("rw,cwv->crv", a, b, precision=hi)

    def mmT(a, b):
        return jnp.einsum("crv,sv->crs", a, b, precision=hi)


    def body(carry, xs):
        best_absq, best_r, best_i, best_idx, best_grad = carry
        ws, base_idx = xs
        gx = jnp.exp(-s2 * (f0[None, :] + ws[:, 0:1]) ** 2)  # (C, W0)
        gy = jnp.exp(-s2 * (f1[None, :] + ws[:, 1:2]) ** 2)  # (C, W1)
        Swr = gx[:, :, None] * Sr[None] * gy[:, None, :] * scale
        Swi = gx[:, :, None] * Si[None] * gy[:, None, :] * scale
        Tr = mm(A0c, Swr) - mm(A0s, Swi)    # (C, n, W1)
        Ti = mm(A0c, Swi) + mm(A0s, Swr)
        Mr = mmT(Tr, A1c) - mmT(Ti, A1s)    # (C, n, m)
        Mi = mmT(Tr, A1s) + mmT(Ti, A1c)
        absq = Mr * Mr + Mi * Mi
        if with_grad:
            ph = -jnp.arctan2(Mi, Mr)
            ggx, ggy = _np_gradient_2d(ph)
        for i in range(ws.shape[0]):
            better = absq[i] > best_absq
            best_absq = jnp.where(better, absq[i], best_absq)
            best_r = jnp.where(better, Mr[i], best_r)
            best_i = jnp.where(better, Mi[i], best_i)
            best_idx = jnp.where(better, base_idx + i, best_idx)
            if with_grad:
                gi = jnp.stack([ggx[i], ggy[i]], axis=-1)
                best_grad = jnp.where(better[..., None], gi, best_grad)
        return (best_absq, best_r, best_i, best_idx, best_grad), None

    base_idx = (jnp.arange(nchunks) * chunk).astype(jnp.int32)
    init = (jnp.zeros((n, m), rdt),
            jnp.zeros((n, m), rdt),
            jnp.zeros((n, m), rdt),
            jnp.zeros((n, m), jnp.int32),
            jnp.zeros((n, m, 2), rdt) if with_grad else jnp.zeros((0,), rdt))
    best_absq, best_r, best_i, best_idx, best_grad = jax.lax.scan(
        body, init, (wl, base_idx))[0]
    return (best_absq, jax.lax.complex(best_r, best_i), best_idx,
            best_grad)


def wfr_sweep_phase_weight(image, wlist, kref, sigma, dr, *,
                           spectrum=None, chunk=8):
    """Demodulated winner phase + interior-masked weight of a WFR
    sweep — the exact inputs reconstruct_u_inv_from_demod consumes
    (weight = sqrt(absq) * (interior mask + 1e-6), the rim mask of
    extract_displacement_field, geometric_phase_analysis.py:923-926)."""
    if int(dr) < 1:
        # at dr=0 the reference's .at[0:-0, 0:-0] rim is an EMPTY slice
        # (weight floor everywhere), which no caller means; the
        # pipeline always passes dr = 2*sigma >= 2.
        raise ValueError("wfr_sweep_phase_weight requires dr >= 1 "
                         f"(got {dr})")
    if spectrum is None:
        image = jnp.asarray(image)
        spectrum = jnp.fft.fft2(image)
    g = wfr_sweep(image, wlist, kref, sigma, with_w=False,
                  rebase=False, return_absq=True, spectrum=spectrum,
                  chunk=chunk)
    rdt = jnp.zeros((), spectrum.real.dtype).dtype
    mask = jnp.zeros(spectrum.shape, rdt).at[dr:-dr, dr:-dr].set(1.0)
    weight = jnp.sqrt(g["absq"]) * (mask + 1e-6)
    return jnp.angle(g["lockin"]).astype(rdt), weight


def wfr_sweep_phase_weight_multi(image, wlists, sigma, dr, *,
                                 spectrum=None, chunk=8,
                                 with_grad=False, krefs=None):
    """Demodulated winner phases + rim-masked weights for ALL Bragg
    peaks of a pipeline sweep: one per-peak sweep each, sharing one
    image spectrum. Returns (phases (G, N, M), weights (G, N, M)).

    with_grad=True additionally returns grads (G, N, M, 2) — each
    peak's wfr2_grad_opt winner phase gradient
    (/root/reference/pyGPA/cuGPA.py:41-87, rebased to the nominal
    k-vector: wrapToPi(2*(g - 2 pi k))/2,
    geometric_phase_analysis.py:812). Requires krefs: (G, 2) nominal
    k-vectors (one per peak)."""
    if with_grad and krefs is None:
        raise ValueError(
            "wfr_sweep_phase_weight_multi(with_grad=True) requires "
            "krefs (the per-peak nominal k-vectors)")
    if spectrum is None:
        image = jnp.asarray(image)
        spectrum = jnp.fft.fft2(image)
    shape = spectrum.shape
    rdt = jnp.zeros((), spectrum.real.dtype).dtype
    phs, wts, gds = [], [], []
    for i, w in enumerate(wlists):
        if with_grad:
            kref = jnp.asarray(krefs, rdt)[i]
            g = wfr_sweep(image, w, kref, sigma, with_grad=True,
                          with_w=False, chunk=chunk, spectrum=spectrum,
                          rebase=False)
            n, m = shape
            mask = jnp.full((n, m), 1e-6, rdt)
            d = int(dr)
            mask = mask.at[d:n - d, d:m - d].add(1.0)
            phs.append(jnp.angle(g["lockin"]))
            wts.append(jnp.abs(g["lockin"]) * mask)
            gds.append(g["grad"])
        else:
            # kref is unused on the demod (rebase=False) path
            ph, wt = wfr_sweep_phase_weight(image, w,
                                            jnp.asarray(w)[0],
                                            sigma, dr,
                                            spectrum=spectrum,
                                            chunk=chunk)
            phs.append(ph)
            wts.append(wt)
    if with_grad:
        return jnp.stack(phs), jnp.stack(wts), jnp.stack(gds)
    return jnp.stack(phs), jnp.stack(wts)


def wfr_sweep(image, wlist, kref, sigma, *, with_grad=False, with_w=True,
              continuity_dk=None, chunk=8, spectrum=None, zoom="auto",
              rebase=True, return_absq=False):
    """Run a WFR sweep over candidate vectors `wlist` rebased to `kref`.

    Parameters
    ----------
    image : (N, M) real array, already mean-subtracted by the caller.
    wlist : (P, 2) candidate reference vectors (row-major grid order to
        match the reference's tie-breaking).
    kref : (2,) vector the output phase is referenced to.
    sigma : float — Gaussian window width (static under jit).
    with_grad : also return the per-pixel phase gradient (the
        wfr2_grad_opt output).
    continuity_dk : if set, enforce the wfr4 continuity constraint
        (forces the sequential path).
    chunk : candidates per batched inverse FFT (memory/speed knob).
    spectrum : optional precomputed fft2(image) to share across the
        per-Bragg-peak sweeps of a pipeline.

    Returns
    -------
    dict with 'lockin' (complex (N, M), phase relative to kref),
    'w' ((2, N, M) winning vectors), and 'grad' ((N, M, 2)) if
    requested — the reference's g-dict contract
    (geometric_phase_analysis.py:615-644).
    """
    if spectrum is None:
        image = jnp.asarray(image)
        spectrum = jnp.fft.fft2(image)
    # keep the ORIGINAL operand for concreteness checks: jnp.asarray
    # inside any jit/vmap trace stages even a numpy constant into a
    # tracer, which would silently disable the zoom plan (the round-1
    # silent-perf-cliff); host lists/arrays stay plannable under
    # transforms this way
    wlist_in = wlist
    wlist_concrete = not isinstance(wlist_in, jax.core.Tracer)
    wlist = jnp.asarray(wlist)
    kref = jnp.asarray(kref)
    shape = spectrum.shape
    rdt = jnp.zeros((), spectrum.real.dtype).dtype

    if continuity_dk is not None:
        plan = (_plan_zoom(shape, np.asarray(wlist_in), float(sigma))
                if (wlist_concrete and zoom is not False) else None)
        if plan is not None:
            best_absq, best_lockin, best_w, _, best_grad = \
                _wfr_sweep_sequential_zoom(
                    spectrum, wlist, jnp.asarray(plan[0]),
                    jnp.asarray(plan[1]), float(sigma), with_grad,
                    float(continuity_dk))
        else:
            best_absq, best_lockin, best_w, _, best_grad = \
                _wfr_sweep_sequential(
                    spectrum, wlist, float(sigma), with_grad,
                    float(continuity_dk))
        w_field = best_w
    else:
        # zoom tri-state: "auto" plans the band-limited matmul sweep
        # when the candidate list is concrete and the window pays off,
        # with an explicit warning on the silent-perf-cliff case
        # (traced wlist under jit -> full-FFT path, same math, much
        # slower at large sizes); True demands the zoom plan and
        # raises if it cannot be built; False forces the full-FFT path.
        plan = None
        if zoom == "auto":
            if not wlist_concrete:
                import warnings
                warnings.warn(
                    "wfr_sweep: candidate list is a traced value, so "
                    "the zoom plan cannot be built; falling back to "
                    "the full-FFT sweep (identical math, slower at "
                    "large sizes). Pass a concrete wlist or "
                    "zoom=False to silence.", stacklevel=2)
            else:
                plan = _plan_zoom(shape, np.asarray(wlist_in),
                                  float(sigma))
        elif zoom:
            if not wlist_concrete:
                raise ValueError(
                    "wfr_sweep(zoom=True) requires a concrete wlist")
            plan = _plan_zoom(shape, np.asarray(wlist_in), float(sigma))
            if plan is None:
                raise ValueError(
                    "wfr_sweep(zoom=True): the bandpass window spans "
                    "most of the spectrum; zoom would not be "
                    "worthwhile (use zoom='auto' or zoom=False)")
        if plan is not None:
            best_absq, best_lockin, best_idx, best_grad = _wfr_sweep_zoom(
                spectrum, jnp.asarray(wlist), jnp.asarray(plan[0]),
                jnp.asarray(plan[1]), float(sigma), with_grad,
                int(min(chunk, wlist.shape[0])))
        else:
            best_absq, best_lockin, best_idx, best_grad = \
                _wfr_sweep_chunked(
                    spectrum, wlist, float(sigma), with_grad,
                    int(min(chunk, wlist.shape[0])))
        # table lookup only when the caller wants the k-map (skipped on
        # the pipeline hot path)
        w_field = None
        if with_w:
            w_field = wlist.astype(rdt)[best_idx]

    if rebase:
        # separable rank-1 plane wave: two length-N exp vectors instead
        # of a full-size transcendental field
        phx = (2 * jnp.pi) * (jnp.arange(shape[0], dtype=rdt)
                              * kref[0].astype(rdt))
        phy = (2 * jnp.pi) * (jnp.arange(shape[1], dtype=rdt)
                              * kref[1].astype(rdt))
        px = jax.lax.complex(jnp.cos(phx), jnp.sin(phx)
                             ).astype(best_lockin.dtype)
        py = jax.lax.complex(jnp.cos(phy), jnp.sin(phy)
                             ).astype(best_lockin.dtype)
        out = {"lockin": best_lockin * px[:, None] * py[None, :]}
    else:
        # demodulated lock-in: phase measured relative to kref's plane
        # wave (full phase = angle(lockin) + 2 pi kref . r); the
        # pipeline consumes wrapped phase *differences*, where the ramp
        # is a constant per-axis shift, so it skips the rebase entirely
        out = {"lockin": best_lockin}
    if return_absq:
        out["absq"] = best_absq
    if w_field is not None:
        out["w"] = jnp.moveaxis(w_field, -1, 0)
    if with_grad:
        g = best_grad - 2 * jnp.pi * kref.astype(rdt)
        out["grad"] = wrap_to_pi(2.0 * g) / 2.0
    return out
