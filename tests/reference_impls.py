"""Slow NumPy oracle implementations for equivalence tests.

These independently implement the published algorithms (spatial
lock-in GPA; windowed-Fourier-ridge sweeps per Kemao 2007; the
Ghiglia-Romero weighted unwrapping CG) in the straightforward
modulate->FFT->filter->IFFT formulation the reference uses, so the
device code's mathematically-restructured versions (single-FFT shifted
Gaussian sweep, closed-form lstsq, while_loop CG) can be checked for
value equivalence — the reference repo's own variant-equivalence test
strategy (SURVEY.md §4).
"""
import numpy as np
import scipy.ndimage as ndi
from scipy.fft import dctn, idctn


def ref_lockin(image, kx, ky, sigma):
    """Literal spatial lock-in: modulate, FFT, Gaussian, IFFT."""
    xx, yy = np.ogrid[0:image.shape[0], 0:image.shape[1]]
    mult = np.exp(2j * np.pi * (xx * kx + yy * ky))
    X = np.fft.fft2(image * mult)
    return np.fft.ifft2(ndi.fourier_gaussian(X, sigma=sigma))


def ref_wfr(image, sigma, kx, ky, kw, kstep, with_grad=False):
    """Sequential WFR sweep with per-candidate rebasing and boolean
    running-max updates (the optwfr2 / wfr2_grad_opt algorithm)."""
    xx, yy = np.ogrid[0:image.shape[0], 0:image.shape[1]]
    g = {"w": np.zeros(image.shape + (2,)),
         "lockin": np.zeros(image.shape, dtype=complex)}
    if with_grad:
        g["grad"] = np.zeros(image.shape + (2,))
    for wx in np.arange(kx - kw, kx + kw, kstep):
        for wy in np.arange(ky - kw, ky + kw, kstep):
            sf = ref_lockin(image, wx, wy, sigma)
            t = np.abs(sf) > np.abs(g["lockin"])
            if with_grad:
                grad = np.stack(np.gradient(-np.angle(sf)), axis=-1)[t]
                g["grad"][t] = grad + 2 * np.pi * np.array([wx - kx,
                                                            wy - ky])
            g["lockin"][t] = sf[t] * np.exp(
                -2j * np.pi * ((wx - kx) * xx + (wy - ky) * yy))[t]
            g["w"][t] = np.array([wx, wy])
    g["w"] = np.moveaxis(g["w"], -1, 0)
    if with_grad:
        g["grad"] = _wrap(2 * g["grad"]) / 2
    return g


def _wrap(x):
    return (x + np.pi) % (2 * np.pi) - np.pi


def ref_residual(dx, dy, weight=None):
    """Initial residual and min-neighbour weights of the weighted
    Poisson system (phase_unwrap.py:154-175) from (N, M-1) / (N-1, M)
    differences."""
    if weight is None:
        WWx = np.ones_like(dx)
        WWy = np.ones_like(dy)
    else:
        WW = weight ** 2
        WWx = np.minimum(WW[:, :-1], WW[:, 1:])
        WWy = np.minimum(WW[:-1, :], WW[1:, :])
    rk = (np.diff(WWx * dx, axis=1, prepend=0, append=0)
          + np.diff(WWy * dy, axis=0, prepend=0, append=0))
    return rk, WWx, WWy


def ref_apply_q(p, WWx, WWy):
    """(A^T)(W^T W)(A) p (phase_unwrap.py:118-132)."""
    qdx = WWx * np.diff(p, axis=1)
    qdy = WWy * np.diff(p, axis=0)
    return (np.diff(qdx, axis=1, prepend=0, append=0)
            + np.diff(qdy, axis=0, prepend=0, append=0))


def ref_phase_unwrap_prediff(dx, dy, weight=None, kmax=100,
                             return_iters=False):
    """Ghiglia-Romero weighted unwrapping PCG from phase differences."""
    rk, WWx, WWy = ref_residual(_wrap(dx), _wrap(dy), weight)
    norm_r0 = np.linalg.norm(rk)
    n, m = rk.shape
    ii, jj = np.ogrid[0:n, 0:m]
    scale = 2 * (np.cos(np.pi * ii / n) + np.cos(np.pi * jj / m) - 2)
    scale[0, 0] = 1.0

    phi = np.zeros_like(rk)
    k = 0
    pk = None
    rzprev = None
    while not np.all(rk == 0.0):
        zk = idctn(dctn(rk) / scale)
        k += 1
        rz = np.tensordot(rk, zk)
        pk = zk if k == 1 else zk + (rz / rzprev) * pk
        rzprev = rz
        Qpk = ref_apply_q(pk, WWx, WWy)
        alpha = rz / np.tensordot(pk, Qpk)
        phi += alpha * pk
        rk = rk - alpha * Qpk
        if k >= kmax or np.linalg.norm(rk) < 1e-9 * norm_r0:
            break
    return (phi, k) if return_iters else phi


def ref_phase_unwrap(psi, weight=None, kmax=100):
    """Unwrap from a wrapped phase image."""
    return ref_phase_unwrap_prediff(np.diff(psi, axis=1),
                                    np.diff(psi, axis=0), weight, kmax)
