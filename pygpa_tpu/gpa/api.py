"""pyGPA-compatible GPA / WFR function surface.

The reference grew nine WFR variants (wfr, wfr2, wfr3, optwfr2,
wfr2_only_lockin[_vec], wfr2_grad[_opt,_vec], wfr4 —
/root/reference/pyGPA/geometric_phase_analysis.py:583-862) that differ
only in output set, rebasing strategy, and batching backend. Here they
are all thin wrappers over one jit-compiled sweep kernel
(ops.wfr.wfr_sweep); the *_vec dask variants are the same kernel (it
is already batched), kept as aliases for API parity.

Candidate grids are built host-side with np.arange to reproduce the
reference's iteration order (row-major in wx, wy) including its
tie-breaking.
"""
import numpy as np
import jax.numpy as jnp

from ..ops.lockin import gpa_lockin, gpa_lockin_batch
from ..ops.wfr import wfr_sweep


def GPA(image, kx, ky, sigma=22):
    """Spatial lock-in (geometric_phase_analysis.py:20-45)."""
    return gpa_lockin(image, jnp.array([kx, ky]), sigma)


def optGPA(image, kvec, sigma=22):
    """Spatial lock-in, kvec as a pair (geometric_phase_analysis.py:48-76)."""
    return gpa_lockin(image, jnp.asarray(kvec), sigma)


def vecGPA(image, kvecs, sigma=22):
    """Batched lock-in over kvecs (geometric_phase_analysis.py:79-89)."""
    return gpa_lockin_batch(image, kvecs, sigma)


def _wgrid(kx, ky, kw, kstep):
    """Row-major (wx outer, wy inner) candidate grid, matching the
    reference's double for-loop over np.arange
    (geometric_phase_analysis.py:679-680)."""
    wxs = np.arange(kx - kw, kx + kw, kstep)
    wys = np.arange(ky - kw, ky + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    return np.stack([wx.ravel(), wy.ravel()], axis=-1)


def wfr(image, sigma, kx, ky, kw, kstep):
    """Adaptive GPA returning wx/wy/phase/r planes
    (geometric_phase_analysis.py:583-612)."""
    g = wfr_sweep(image, _wgrid(kx, ky, kw, kstep), (kx, ky), sigma)
    return {"wx": g["w"][0], "wy": g["w"][1],
            "phase": jnp.angle(g["lockin"]),
            "r": jnp.abs(g["lockin"])}


def wfr2(image, sigma, kx, ky, kw, kstep):
    """Adaptive GPA returning the winning k-field and complex lock-in
    (geometric_phase_analysis.py:615-644)."""
    return wfr_sweep(image, _wgrid(kx, ky, kw, kstep), (kx, ky), sigma)


# The reference's optwfr2 computes identical values to wfr2 with fewer
# ops; here both names are the same single-FFT sweep.
optwfr2 = wfr2


def wfr3(image, sigma, klist, kref):
    """Sweep an explicit k-list, rebased to kref
    (geometric_phase_analysis.py:647-666)."""
    return wfr_sweep(image, np.asarray(klist), np.asarray(kref), sigma)


def wfr4(image, sigma, klist, kref, dk):
    """wfr3 with the k-continuity constraint
    |w_new - w_old| < 2*sqrt(2)*dk (geometric_phase_analysis.py:839-862)."""
    return wfr_sweep(image, np.asarray(klist), np.asarray(kref), sigma,
                     continuity_dk=dk)


def wfr2_only_lockin(image, sigma, kx, ky, kw, kstep):
    """Lock-in-only sweep (geometric_phase_analysis.py:689-702)."""
    return wfr_sweep(image, _wgrid(kx, ky, kw, kstep),
                     (kx, ky), sigma)["lockin"]


# dask-vectorized variant of the reference == the same batched kernel
wfr2_only_lockin_vec = wfr2_only_lockin


def wfr2_grad_opt(image, sigma, kx, ky, kw, kstep):
    """Sweep also returning the lock-in phase gradient
    (geometric_phase_analysis.py:763-813)."""
    return wfr_sweep(image, _wgrid(kx, ky, kw, kstep), (kx, ky), sigma,
                     with_grad=True)


# wfr2_grad (:722-760) and wfr2_grad_vec (:816-836) compute the same
# result via np.gradient + final wrapToPi(2g)/2; one kernel here.
wfr2_grad = wfr2_grad_opt
wfr2_grad_vec = wfr2_grad_opt


def generate_klists(pks, dk=None, kmax=1.9, kmin=0.2, sort_list=False):
    """Voronoi-restricted annulus k-lists for wfr3/wfr4
    (geometric_phase_analysis.py:865-889). Host-side numpy: output
    shapes are data-dependent and tiny."""
    pks = np.asarray(pks)
    doubleks = np.concatenate([pks, -pks])
    kmax = np.linalg.norm(pks, axis=1).max() * kmax
    kmin = np.linalg.norm(pks, axis=1).max() * kmin
    if dk is None:
        dk = np.linalg.norm(pks, axis=1).mean() / 10
    kk = np.mgrid[-kmax:kmax:0.005, -kmax:kmax:0.005]
    dists = ((np.moveaxis(kk[..., None], 0, -1) - doubleks) ** 2).sum(axis=-1)
    r = (kk ** 2).sum(axis=0)
    kmask0 = (r < kmax ** 2) & (r > kmin ** 2)
    klists = []
    for i, pk in enumerate(pks):
        kmask = kmask0 & (dists.min(axis=-1) == dists[..., i])
        klist = kk[:, kmask].T
        if sort_list:
            ampl = np.linalg.norm(klist - pks[i], axis=1)
            klist = klist[np.argsort(ampl.reshape((-1)))]
        klists.append(klist)
    return klists
