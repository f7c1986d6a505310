"""Primary k-vector (Bragg/moire peak) detection.

Reference behavior: /root/reference/pyGPA/geometric_phase_analysis.py:
371-548. Split for the device: everything dense (Moisan periodic
decomposition, |FFT|, Gaussian/DoG smoothing, local-max masking) runs
as one jit-compiled device program; the tiny data-dependent parts
(coordinate lists, de-duplication, the recursive threshold/sigma
adaptation) stay on host, exactly mirroring the reference's adaptive
control flow.
"""
from functools import partial
from itertools import combinations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.fourier import moisan_per, gaussian_filter_fft
from ..core.mathtools import remove_negative_duplicates as _rnd
from ..ops.peaks import local_max_mask


def remove_negative_duplicates(ks):
    """GPA-module variant (norm-scaled atol,
    geometric_phase_analysis.py:371-385)."""
    return _rnd(ks, atol_scale="norm")


def smallest_sum(ks):
    """Smallest +/- sum of 3 k-vectors (geometric_phase_analysis.py:
    539-548): how close the triplet comes to a closed triangle."""
    if len(ks) != 3:
        return np.nan
    M = np.ones((3, 3)) - 2 * np.eye(3)
    sums = M @ np.asarray(ks)
    return sums[np.argmin(np.linalg.norm(sums, axis=1))]


def select_closest_to_triangle(ks):
    """Select the 3 ks closest to a closed triangle
    (geometric_phase_analysis.py:531-536)."""
    combis = list(combinations(np.asarray(ks), 3))
    sums = [np.linalg.norm(smallest_sum(c)) for c in combis]
    return np.array(combis[int(np.argmin(sums))])


@partial(jax.jit, static_argnames=("dog",))
def _peak_image(image, sigma, dog):
    """Device part: periodic-component |FFT|, smoothed (optionally DoG).
    Returns the smoothed spectrum (fftshifted)."""
    image = image - image.mean()
    pd, _ = moisan_per(image, inverse_dft=False)
    fftim = jnp.abs(jnp.fft.fftshift(pd))
    smooth = gaussian_filter_fft(fftim, sigma)
    if dog:
        smooth = smooth - gaussian_filter_fft(fftim, 50.0)
    return smooth


_MAX_PEAKS = 128


@partial(jax.jit, static_argnames=("dog",))
def _peak_candidates(image, sigma, threshold, rlo, rhi, dog):
    """One device program per detection attempt: smoothed spectrum,
    local-max mask, top-K candidate extraction, and the 3x3
    neighborhoods for sub-bin refinement. Only O(K) scalars cross to
    the host (the reference pulls the full smoothed spectrum per
    recursion level, a full-image device-to-host transfer every
    retry).

    The (rlo, rhi) pix_norm_range annulus is applied ON DEVICE before
    the top-K so strong out-of-range maxima (the DC hump, high-q noise)
    cannot crowd genuine in-range Bragg peaks out of the K slots."""
    smooth = _peak_image(image, sigma, dog)
    mask = local_max_mask(smooth, threshold.astype(smooth.dtype))
    n_, m_ = smooth.shape
    ri = (jnp.arange(n_, dtype=smooth.dtype) - n_ // 2)[:, None]
    rj = (jnp.arange(m_, dtype=smooth.dtype) - m_ // 2)[None, :]
    r2 = ri * ri + rj * rj
    mask = mask & (r2 > rlo * rlo) & (r2 < rhi * rhi)
    vals = jnp.where(mask, smooth, -jnp.inf)
    k = min(_MAX_PEAKS, vals.size)
    top_vals, flat_idx = jax.lax.top_k(vals.ravel(), k)
    ii, jj = jnp.unravel_index(flat_idx, smooth.shape)
    n, m = smooth.shape
    starts_i = jnp.clip(ii - 1, 0, n - 3)
    starts_j = jnp.clip(jj - 1, 0, m - 3)
    neigh = jax.vmap(lambda si, sj: jax.lax.dynamic_slice(
        smooth, (si, sj), (3, 3)))(starts_i, starts_j)
    valid = jnp.isfinite(top_vals).astype(smooth.dtype)
    return (top_vals, ii.astype(jnp.int32), jj.astype(jnp.int32),
            neigh, valid)


def _decrease_threshold(t):
    """Threshold adaptation schedule (geometric_phase_analysis.py:388-394)."""
    if t > 0.001:
        if t >= 0.2:
            t = t - 0.1
        else:
            t = t / 2
    return t


def _subpixel_refine(neigh, cindices, shape):
    """Quadratic (log-parabolic) sub-bin refinement of peak positions
    from the (K, 3, 3) neighborhoods of the detected maxima (vectorized
    host numpy on the tiny gathered windows; border peaks keep their
    integer position). Improves the grid-limited k accuracy (~1/size)
    by an order of magnitude on smooth peaks. An addition beyond the
    reference."""
    neigh = np.asarray(neigh, np.float64)
    ii = cindices[:, 0]
    jj = cindices[:, 1]
    n, m = shape
    interior_i = (ii > 0) & (ii < n - 1)
    interior_j = (jj > 0) & (jj < m - 1)
    # The 3x3 window was clip-shifted at image borders, so the peak
    # sits at (ii - starts_i, jj - starts_j), not necessarily (1, 1):
    # a border-row peak must still refine its COLUMN from its own row
    # (and vice versa), not from the window-center row.
    ci = ii - np.clip(ii - 1, 0, n - 3)
    cj = jj - np.clip(jj - 1, 0, m - 3)
    k = np.arange(len(ii))
    col = neigh[k, :, cj]          # (K, 3) column through the peak
    row = neigh[k, ci, :]          # (K, 3) row through the peak
    den_i = col[:, 0] - 2 * col[:, 1] + col[:, 2]
    den_j = row[:, 0] - 2 * row[:, 1] + row[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        di = np.clip(0.5 * (col[:, 0] - col[:, 2]) / den_i, -0.5, 0.5)
        dj = np.clip(0.5 * (row[:, 0] - row[:, 2]) / den_j, -0.5, 0.5)
    di = np.where(interior_i & (den_i < 0), di, 0.0)
    dj = np.where(interior_j & (den_j < 0), dj, 0.0)
    return np.stack([ii + di, jj + dj], axis=-1)


def extract_primary_ks(image, plot=False, threshold=0.7,
                       pix_norm_range=(2, 200), sigma=1, NMPERPIXEL=1.0,
                       DoG=True, subpixel=False):
    """Extract the primary k-vectors of a lattice image from its
    smoothed Fourier magnitude, recursively adapting threshold/sigma
    until (ideally) three primary ks emerge
    (geometric_phase_analysis.py:397-528).

    Returns (primary_ks (N, 2), all_ks (N+M, 2)) as numpy arrays.
    """
    image = jnp.asarray(image)
    # ONE device program; only O(K) peak records cross to the host
    top_vals, pii, pjj, neigh, valid = _peak_candidates(
        image, jnp.asarray(float(sigma)),
        jnp.asarray(float(threshold)),
        jnp.asarray(float(pix_norm_range[0])),
        jnp.asarray(float(pix_norm_range[1])), bool(DoG))
    valid_h = np.asarray(valid) > 0.5
    vals_h = np.asarray(top_vals)[valid_h]   # descending (top_k order)
    cindices = np.stack([np.asarray(pii)[valid_h],
                         np.asarray(pjj)[valid_h]], axis=-1)
    neigh_h = np.asarray(neigh)[valid_h]

    kxs = np.fft.fftshift(np.fft.fftfreq(image.shape[0]))
    kys = np.fft.fftshift(np.fft.fftfreq(image.shape[1]))
    center = np.array(image.shape) // 2
    coords = cindices - center
    norms = np.linalg.norm(coords, axis=1) if len(coords) else np.zeros(0)
    selection = (norms < pix_norm_range[1]) & (norms > pix_norm_range[0])
    cindices = cindices[selection]
    coords = coords[selection]
    vals_h = vals_h[selection]
    neigh_h = neigh_h[selection]

    if subpixel and len(cindices):
        pos = _subpixel_refine(neigh_h, cindices, image.shape)
        all_ks = np.stack(
            [(pos[:, 0] - image.shape[0] // 2) / image.shape[0],
             (pos[:, 1] - image.shape[1] // 2) / image.shape[1]], -1)
    elif len(cindices):
        all_ks = np.array([kxs[cindices.T[0]], kys[cindices.T[1]]]).T
    else:
        all_ks = np.zeros((0, 2))
    all_ks = remove_negative_duplicates(all_ks)

    newparams = False
    if len(all_ks) < 3:
        newparams = True
        if len(all_ks) == 0:
            if threshold > _decrease_threshold(threshold):
                threshold = _decrease_threshold(threshold)
            else:
                print("No ks found at minimum threshold!")
                newparams = False
        else:
            coordsminlength = np.linalg.norm(coords, axis=1).min()
            peakvals = vals_h.max()
            if coordsminlength < 5 * sigma:
                sigma = coordsminlength / 6
            elif threshold > 0.2 * peakvals:
                threshold = 0.2 * peakvals
            elif threshold > _decrease_threshold(threshold):
                threshold = _decrease_threshold(threshold)
            else:
                print("Can't find enough ks!")
                newparams = False
        if newparams:
            primary_ks, all_ks = extract_primary_ks(
                image, plot=False, threshold=threshold, sigma=sigma,
                pix_norm_range=pix_norm_range, DoG=DoG,
                subpixel=subpixel)
        else:
            primary_ks = all_ks.copy()

    if not newparams:
        primary_ks = all_ks.copy()

    if len(primary_ks) != 3:
        if len(primary_ks) > 3:
            primary_ks = select_closest_to_triangle(all_ks)
        elif len(all_ks) > 6:
            primary_ks = select_closest_to_triangle(all_ks)
        elif threshold > _decrease_threshold(threshold) and not newparams:
            threshold = _decrease_threshold(threshold)
            primary_ks, all_ks = extract_primary_ks(
                image, plot=False, threshold=threshold, sigma=sigma,
                pix_norm_range=pix_norm_range, DoG=DoG,
                subpixel=subpixel)
        else:
            primary_ks = all_ks.copy()

    if plot:  # pragma: no cover - debug visualization
        from ..imagetools import fftplot
        import matplotlib.pyplot as plt
        smooth_h = np.asarray(_peak_image(
            image, jnp.asarray(float(sigma)), bool(DoG)))
        fig, ax = plt.subplots(ncols=2, figsize=[12, 8])
        fftplot(smooth_h, d=NMPERPIXEL, ax=ax[0], pcolormesh=False,
                origin="lower")
        ax[0].scatter(*(all_ks / NMPERPIXEL).T, color="red", alpha=0.2, s=50)
        ax[0].scatter(*(np.asarray(primary_ks) / NMPERPIXEL).T,
                      color="black", alpha=0.7, s=50, marker="x")
        ax[1].imshow(np.asarray(image).T, origin="lower")
    return primary_ks, all_ks
