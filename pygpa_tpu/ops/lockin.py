"""Spatial lock-in (the core GPA operation).

lockin_k(r) = IFFT[ G_sigma(q) FFT[ I(r) e^{2 pi i k.r} ] ](r): multiply
by a reference plane wave, low-pass in the Fourier domain with a
Gaussian of width sigma, transform back. The complex result's angle is
the geometric phase of the lattice component at k, its magnitude the
local amplitude (= confidence weight).

Replaces GPA / optGPA / vecGPA and the CuPy mirror cuGPA
(/root/reference/pyGPA/geometric_phase_analysis.py:20-89,
cuGPA.py:11-38). Two formulations are provided:

 - gpa_lockin: the literal modulate->FFT->filter->IFFT chain (one
   forward + one inverse FFT per k);
 - lockin_from_spectrum: the shifted-Gaussian identity
   L_k(r) = e^{2 pi i k.r} IFFT[ FFT[I](q) G_sigma(q + k) ](r),
   which reuses a single forward FFT of the image across any number of
   k-vectors — the basis of the WFR sweep (ops/wfr.py). The two agree
   to floating-point precision because the Gaussian's aliasing tails
   (the only difference) are exp(-(N/2)^2 / (2 sigma^2)) ~ 1e-30 for
   the sigma ~ 1/|k| windows GPA uses.
"""
import jax
import jax.numpy as jnp

from ..core.fourier import fourier_gaussian_multiplier


def _complex_dtype(dtype):
    return jnp.complex128 if dtype == jnp.float64 else jnp.complex64


def plane_wave(shape, kvec, dtype=jnp.float32, sign=1.0):
    """exp(sign * 2 pi i (x kx + y ky)) on the pixel grid."""
    cdt = _complex_dtype(dtype)
    x = jnp.arange(shape[0], dtype=dtype)[:, None]
    y = jnp.arange(shape[1], dtype=dtype)[None, :]
    phase = 2 * jnp.pi * (x * kvec[0] + y * kvec[1]) * sign
    ph = phase.astype(dtype)
    return jax.lax.complex(jnp.cos(ph), jnp.sin(ph)).astype(cdt)


def gpa_lockin(image, kvec, sigma=22.0):
    """Spatial lock-in of `image` at reference vector `kvec`.

    Drop-in for pyGPA GPA/optGPA (geometric_phase_analysis.py:20-76);
    kvec is a length-2 array (kx, ky) in unit cells / pixel.
    """
    image = jnp.asarray(image)
    mult = plane_wave(image.shape, kvec, image.dtype)
    X = jnp.fft.fft2(image * mult)
    G = fourier_gaussian_multiplier(image.shape, sigma, image.dtype)
    return jnp.fft.ifft2(G * X)


def gpa_lockin_batch(image, kvecs, sigma=22.0):
    """Lock-in at a batch of k-vectors (vecGPA,
    geometric_phase_analysis.py:79-89): vmapped over kvecs, one batched
    FFT instead of a dask graph."""
    return jax.vmap(lambda k: gpa_lockin(image, k, sigma))(jnp.asarray(kvecs))


def lockin_from_spectrum(spectrum, kvec, sigma, rebase=None):
    """Lock-in from a precomputed image spectrum (single-FFT path).

    Returns M_k(r) = IFFT[ spectrum(q) * G_sigma(q + kvec) ], the
    lock-in signal *demodulated* by kvec (phase measured relative to
    kvec's plane wave). Multiply by plane_wave(shape, kvec - rebase)
    ... i.e. the caller applies e^{2 pi i k_ref . r} to re-reference.
    """
    G = fourier_gaussian_multiplier(spectrum.shape, sigma,
                                    jnp.zeros((), spectrum.real.dtype).dtype,
                                    shift=(kvec[0], kvec[1]))
    out = jnp.fft.ifft2(spectrum * G.astype(spectrum.dtype))
    if rebase is not None:
        out = out * plane_wave(spectrum.shape, rebase,
                               jnp.zeros((), spectrum.real.dtype).dtype)
    return out
