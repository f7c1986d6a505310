"""Fourier-domain building blocks: Gaussian multipliers, FFT-based DCT,
Moisan periodic-plus-smooth decomposition, FFT smoothing, Wiener filter.

XLA has fast batched complex FFTs (cuFFT on the GPU) but no native DCT;
the DCT-II / inverse pair here uses the Makhoul length-N permutation +
twiddle trick so a 2D DCT costs exactly one complex FFT per axis. All functions are
jittable and dtype-preserving (float32 by default, float64 with x64).

Reference behavior replaced:
 - scipy.ndimage.fourier_gaussian      -> fourier_gaussian_multiplier
 - scipy.fft.dctn / idctn              -> dct2n / idct2n
 - moisan2011.per                      -> moisan_per
   (used at /root/reference/pyGPA/geometric_phase_analysis.py:429)
 - scipy.ndimage.gaussian_filter       -> gaussian_filter_fft
 - skimage.restoration.wiener          -> wiener_deconvolve
   (used at /root/reference/pyGPA/geometric_phase_analysis.py:901-903)
"""
import numpy as np
import jax.numpy as jnp


def _real_dtype(dtype):
    return jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.floating) \
        else jnp.zeros((), dtype).real.dtype


def fourier_gaussian_multiplier(shape, sigma, dtype=jnp.float32,
                                shift=(0.0, 0.0)):
    """Fourier-domain Gaussian window exp(-2 pi^2 sigma^2 |f + shift|^2).

    Equals scipy.ndimage.fourier_gaussian's multiplier on an fft2 grid
    (used at geometric_phase_analysis.py:44,75,87). `shift` evaluates
    the analytic Gaussian at frequencies offset by a (possibly
    fractional) k-vector — the key to the single-FFT WFR sweep in
    ops/wfr.py.
    """
    fx = jnp.fft.fftfreq(shape[0]).astype(dtype) + shift[0]
    fy = jnp.fft.fftfreq(shape[1]).astype(dtype) + shift[1]
    arg = fx[:, None] ** 2 + fy[None, :] ** 2
    s2 = jnp.asarray(2.0 * np.pi ** 2, dtype) * jnp.asarray(sigma, dtype) ** 2
    return jnp.exp(-s2 * arg)


def dct2_1d(x):
    """Unnormalized DCT-II along the last axis (== scipy.fft.dct, norm=None).

    Makhoul's single-FFT algorithm: permute to v = [x0, x2, ..., x3, x1],
    FFT, twiddle by exp(-i pi k / 2n), keep 2*Re. For even lengths the
    even/odd split is a reshape instead of two strided gathers.
    """
    n = x.shape[-1]
    if n % 2 == 0:
        pairs = x.reshape(x.shape[:-1] + (n // 2, 2))
        v = jnp.concatenate([pairs[..., 0], pairs[..., 1][..., ::-1]],
                            axis=-1)
    else:
        v = jnp.concatenate([x[..., ::2], x[..., 1::2][..., ::-1]],
                            axis=-1)
    k = jnp.arange(n, dtype=_real_dtype(x.dtype))
    F = jnp.fft.fft(v)
    W = jnp.exp(-1j * jnp.pi * k / (2 * n)).astype(F.dtype)
    return 2 * (F * W).real


def idct2_1d(y):
    """Exact inverse of dct2_1d (== scipy.fft.idct, type 2, norm=None)."""
    n = y.shape[-1]
    k = jnp.arange(n, dtype=_real_dtype(y.dtype))
    # G_k = (y_k - i y_{n-k}) / 2 with y_n := 0
    ynk = jnp.concatenate([jnp.zeros_like(y[..., :1]), y[..., :0:-1]], axis=-1)
    G = (y - 1j * ynk) * 0.5
    F = G * jnp.exp(1j * jnp.pi * k / (2 * n)).astype(G.dtype)
    v = jnp.fft.ifft(F).real
    half = (n + 1) // 2
    if n % 2 == 0:
        # interleave via stack+reshape (no strided scatter):
        # x[2j] = v[j], x[2j+1] = v[n-1-j]
        x = jnp.stack([v[..., :half], v[..., half:][..., ::-1]],
                      axis=-1).reshape(y.shape)
    else:
        x = jnp.zeros_like(y)
        x = x.at[..., ::2].set(v[..., :half])
        x = x.at[..., 1::2].set(v[..., half:][..., ::-1])
    return x


def dct2n(x):
    """2D DCT-II over the last two axes (== scipy.fft.dctn, norm=None)."""
    x = dct2_1d(x)
    return jnp.swapaxes(dct2_1d(jnp.swapaxes(x, -1, -2)), -1, -2)


def idct2n(x):
    """2D inverse DCT-II over the last two axes (== scipy.fft.idctn)."""
    x = jnp.swapaxes(idct2_1d(jnp.swapaxes(x, -1, -2)), -1, -2)
    return idct2_1d(x)


def moisan_per(image, inverse_dft=True):
    """Moisan periodic-plus-smooth decomposition image = p + s.

    Removes the cross artefact that non-periodic boundaries leave in the
    DFT, so Bragg-peak detection sees clean peaks. In-repo replacement
    for moisan2011.per (geometric_phase_analysis.py:8,429). The smooth
    component solves a discrete Laplace equation driven by the boundary
    jumps; its DFT is the boundary image's DFT divided by the Laplacian
    symbol.

    With inverse_dft=False returns (p_dft, s_dft); otherwise (p, s).

    Reference: L. Moisan, "Periodic plus smooth image decomposition",
    J. Math. Imaging Vis. 39, 161-179 (2011).
    """
    image = jnp.asarray(image)
    m, n = image.shape[-2:]
    dt = _real_dtype(image.dtype)
    arg_m = (2 * jnp.pi * jnp.fft.fftfreq(m)).astype(dt)
    arg_n = (2 * jnp.pi * jnp.fft.fftfreq(n)).astype(dt)
    cos_m, sin_m = jnp.cos(arg_m), jnp.sin(arg_m)
    cos_n, sin_n = jnp.cos(arg_n), jnp.sin(arg_n)

    # boundary image: v[0,:] = u[-1,:]-u[0,:], v[-1,:] = -(u[-1,:]-u[0,:])
    # whose DFT along axis 0 is fft(w1) * (1 - exp(2 pi i q/m))
    w1 = image[..., -1, :] - image[..., 0, :]
    v_dft = jnp.fft.fft(w1)[..., None, :] * \
        (1.0 - cos_m - 1j * sin_m)[:, None]
    w2 = image[..., :, -1] - image[..., :, 0]
    v_dft = v_dft + jnp.fft.fft(w2)[..., :, None] * \
        (1.0 - cos_n - 1j * sin_n)[None, :]

    denom = 2.0 * (cos_m[:, None] + cos_n[None, :] - 2.0)
    denom = denom.at[0, 0].set(1.0)
    s_dft = v_dft / denom
    s_dft = s_dft.at[..., 0, 0].set(0.0)
    p_dft = jnp.fft.fft2(image) - s_dft
    if inverse_dft:
        return jnp.fft.ifft2(p_dft).real, jnp.fft.ifft2(s_dft).real
    return p_dft, s_dft


def gaussian_filter_fft(image, sigma):
    """Gaussian smoothing via Fourier multiplication (circular boundary).

    Replaces scipy.ndimage.gaussian_filter on the smoothed-|FFT| images
    of peak detection (geometric_phase_analysis.py:432-434), where the
    data is already near-periodic so circular boundary handling is
    appropriate and the whole op stays on device as FFT*mult*iFFT.
    """
    image = jnp.asarray(image)
    mult = fourier_gaussian_multiplier(image.shape[-2:], sigma,
                                       _real_dtype(image.dtype))
    return jnp.fft.ifft2(jnp.fft.fft2(image) * mult).real


def laplacian_transfer(shape, dtype=jnp.float32):
    """DFT transfer function of the (periodic) 5-point Laplacian with
    center 4 and neighbors -1 — exactly skimage.restoration.uft.
    laplacian's convention, so the reference's balance=5000 transfers
    unchanged (geometric_phase_analysis.py:892-904)."""
    fx = jnp.fft.fftfreq(shape[0]).astype(dtype)
    fy = jnp.fft.fftfreq(shape[1]).astype(dtype)
    lap = (2 * jnp.cos(2 * jnp.pi * fx)[:, None]
           + 2 * jnp.cos(2 * jnp.pi * fy)[None, :] - 4.0)
    return -lap  # positive semi-definite, peak 8 at Nyquist


def wiener_deconvolve(image, transfer, balance):
    """Tikhonov-regularized Wiener deconvolution in the Fourier domain.

    x_hat = IFFT[ conj(H) / (|H|^2 + balance |L|^2) FFT(y) ] with the
    Laplacian regularizer L, the same estimator
    skimage.restoration.wiener computes (used by gaussian_deconvolve,
    geometric_phase_analysis.py:892-904). `transfer` is the real DFT of
    the blur kernel on this grid.
    """
    image = jnp.asarray(image)
    L = laplacian_transfer(image.shape[-2:], _real_dtype(image.dtype))
    H = transfer
    filt = H / (H * H + balance * L * L)
    return jnp.fft.ifft2(jnp.fft.fft2(image) * filt).real


def fftbounds(n, d=1):
    """Frequency bin edges for pcolormesh-style plotting
    (imagetools.py:22-26). Host-side numpy."""
    r = np.fft.fftshift(np.fft.fftfreq(n, d))
    return np.append(r, r[-1] + 1 / (n * d))
