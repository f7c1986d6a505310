"""Row-sharded weighted phase unwrap and the fully-sharded
displacement pipeline.

Completes the larger-than-one-device story (SURVEY.md §5 'Multi-device
scaling'; reference analogue: dask chunking,
/root/reference/pyGPA/geometric_phase_analysis.py:705-719): after the
spatially-sharded WFR sweep (parallel/fft.py) the image's phases stay
ROW-SHARDED through the remaining pipeline stages:

 - weighted lstsq: per-pixel closed form (solvers/lstsq.py) —
   elementwise, GSPMD keeps the sharding with zero collectives;
 - the Ghiglia-Romero CG unwrap runs with a DISTRIBUTED DCT
   preconditioner: the same pencil all_to_all pattern as fft2_sharded
   (last-axis DCT local, one all_to_all to re-pencil columns, row-axis
   DCT local, all_to_all back), plugged into solvers/unwrap.py via its
   `precond` hook. CG stencils (diff/pad halos) and inner products
   compile to halo exchanges / all-reduces under jit;
 - the multigrid V-cycle's averaging/upsampling matmuls partition over
   the row axis automatically.

The unwrap algorithm itself is exactly solvers/unwrap.py (reference
phase_unwrap.py:141-208); only the preconditioner's transforms are
distributed.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULTS
from ..core.fourier import dct2_1d, idct2_1d
from ..core.mathtools import wrap_to_pi
from ..gpa.pipeline import pipeline_candidate_grids
from ..solvers.lstsq import weighted_lstsq_stack
from ..solvers.unwrap import (_cg_unwrap, _residual,
                              phase_unwrap_prediff_mg)
from .fft import fft2_sharded, wfr_sweep_spatial


def _dct_axis2(x):
    return jnp.swapaxes(dct2_1d(jnp.swapaxes(x, -1, -2)), -1, -2)


def _idct_axis2(x):
    return jnp.swapaxes(idct2_1d(jnp.swapaxes(x, -1, -2)), -1, -2)


def _pencil_dct(x_local, axis_name, inverse):
    """Local (..., n/D, m) block -> 2D-DCT'd local block. Last axis
    first (rows complete locally), re-pencil via all_to_all so the row
    axis is complete, transform it, pencil back — the fft2_sharded
    pattern with DCT-II in place of the complex FFT."""
    sa = x_local.ndim - 1
    ca = x_local.ndim - 2
    if inverse:
        xt = jax.lax.all_to_all(x_local, axis_name, split_axis=sa,
                                concat_axis=ca, tiled=True)
        xt = _idct_axis2(xt)
        x_local = jax.lax.all_to_all(xt, axis_name, split_axis=ca,
                                     concat_axis=sa, tiled=True)
        return idct2_1d(x_local)
    x_local = dct2_1d(x_local)
    xt = jax.lax.all_to_all(x_local, axis_name, split_axis=sa,
                            concat_axis=ca, tiled=True)
    xt = _dct_axis2(xt)
    return jax.lax.all_to_all(xt, axis_name, split_axis=ca,
                              concat_axis=sa, tiled=True)


def dct2n_sharded(x, mesh, axis="batch"):
    """2D DCT-II of a row-sharded (..., N, M) array (P(axis, None) on
    the last two axes); returns the row-sharded transform."""
    spec = P(*((None,) * (x.ndim - 2) + (axis, None)))
    fn = shard_map(partial(_pencil_dct, axis_name=axis, inverse=False),
                   mesh=mesh, in_specs=spec, out_specs=spec)
    return fn(x)


def idct2n_sharded(x, mesh, axis="batch"):
    spec = P(*((None,) * (x.ndim - 2) + (axis, None)))
    fn = shard_map(partial(_pencil_dct, axis_name=axis, inverse=True),
                   mesh=mesh, in_specs=spec, out_specs=spec)
    return fn(x)


def _poisson_scale_np(shape, dtype):
    n, m = shape
    i = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(m, dtype=np.float64)[None, :]
    scale = 2.0 * (np.cos(np.pi * i / n) + np.cos(np.pi * j / m) - 2.0)
    scale[0, 0] = 1.0
    return jnp.asarray(scale, dtype)


_FACTORY_CACHE = {}


def make_sharded_precond_factory(mesh, axis, dtype):
    """precond_factory for solvers.unwrap.phase_unwrap_prediff_mg /
    _cg_unwrap: per level shape, an unweighted-Poisson solve whose DCT
    pair runs the pencil all_to_all pattern. Levels must keep both
    axes divisible by the mesh axis size. Factories (and their per-
    shape precond closures) are cached so repeated eager calls reuse
    the same static callable and _cg_unwrap does not retrace."""
    key = (mesh, axis, jnp.dtype(dtype).name)
    if key in _FACTORY_CACHE:
        return _FACTORY_CACHE[key]
    cache = {}

    def factory(shape):
        if shape not in cache:
            scale = _poisson_scale_np(shape, dtype)

            def precond(rk, _scale=scale):
                return idct2n_sharded(
                    dct2n_sharded(rk, mesh, axis) / _scale, mesh, axis)

            cache[shape] = precond
        return cache[shape]

    _FACTORY_CACHE[key] = factory
    return factory


def phase_unwrap_prediff_sharded(dx, dy, weight, mesh, axis="batch",
                                 kmax=10, coarse=None):
    """Row-sharded weighted gradient integration (drop-in for
    solvers.unwrap.phase_unwrap_prediff / _mg on sharded planes)."""
    factory = make_sharded_precond_factory(mesh, axis, dx.dtype)
    if coarse:
        # clamp the coarse-level iterations exactly like the
        # single-device path (reconstruct_u_inv_from_demod) so the
        # sharded and single-device multigrid solves stay
        # schedule-identical
        kmg = min(int(kmax), DEFAULTS.unwrap_kmax_mg)
        return phase_unwrap_prediff_mg(dx, dy, weight, kmax=kmg,
                                       coarse=coarse,
                                       precond_factory=factory)
    dx = wrap_to_pi(jnp.asarray(dx))
    dy = wrap_to_pi(jnp.asarray(dy))
    rk, WWx, WWy = _residual(dx, dy, weight)
    n = dx.shape[-2]
    m = dy.shape[-1]
    phi, _ = _cg_unwrap(rk, WWx, WWy, int(kmax), factory((n, m)))
    return phi


def reconstruct_u_inv_from_demod_sharded(kvecs, phases_demod, weights,
                                         mesh, axis="batch", kmax=10,
                                         unwrap_coarse=None):
    """Row-sharded counterpart of
    gpa.reconstruct.reconstruct_u_inv_from_demod: wrap-differences and
    the per-pixel lstsq partition elementwise; each displacement
    component then integrates with the distributed unwrap."""
    kvecs = jnp.asarray(kvecs)
    phases_demod = jnp.asarray(phases_demod)
    K = 2 * jnp.pi * kvecs
    dbdx = wrap_to_pi(jnp.diff(phases_demod, axis=2)
                      + K[:, 1, None, None])
    dbdy = wrap_to_pi(jnp.diff(phases_demod, axis=1)
                      + K[:, 0, None, None])
    dudx = weighted_lstsq_stack(dbdx, K, weights[:, :, : dbdx.shape[2]])
    dudy = weighted_lstsq_stack(dbdy, K, weights[:, : dbdy.shape[1], :])
    wnorm = jnp.linalg.norm(weights, axis=0)
    # two sequential component solves (the batched vmap of the
    # single-device path would vmap over shard_map; unrolling keeps
    # the collectives simple)
    us = [phase_unwrap_prediff_sharded(dudx[c], dudy[c], wnorm, mesh,
                                       axis, kmax=kmax,
                                       coarse=unwrap_coarse)
          for c in range(2)]
    return jnp.stack(us)


def extract_displacement_field_sharded(image, kvecs, mesh,
                                       axis="batch", sigma=None,
                                       kwscale=DEFAULTS.kw_scale,
                                       ksteps=DEFAULTS.ksteps,
                                       kmax=DEFAULTS.
                                       unwrap_kmax_reconstruct,
                                       unwrap_coarse=None):
    """extract_displacement_field for ONE image too large for a single
    device's memory: the image stays row-sharded (P(axis, None)) through
    pencil FFT -> spatially-sharded WFR sweeps -> per-pixel lstsq ->
    distributed multigrid unwrap. Same math as the single-device
    pipeline (geometric_phase_analysis.py:907-932); equivalence is
    tested on the 8-device CPU mesh (tests/test_parallel.py)."""
    kvecs_h = np.asarray(kvecs, np.float64)
    sigma, wlists = pipeline_candidate_grids(kvecs_h, sigma, kwscale,
                                             ksteps)
    dr = 2 * sigma

    image = jnp.asarray(image)
    n, m = image.shape
    rdt = image.dtype
    sh = NamedSharding(mesh, P(axis, None))
    image = jax.device_put(image, sh)
    img0 = image - image.mean()
    spectrum = fft2_sharded(img0, mesh, axis=axis)

    ii = jnp.arange(n)[:, None]
    jj = jnp.arange(m)[None, :]
    interior = ((ii >= dr) & (ii < n - dr)
                & (jj >= dr) & (jj < m - dr))
    mask = interior.astype(rdt) + jnp.asarray(1e-6, rdt)

    phs, wts = [], []
    for pk, wlist in zip(kvecs_h, wlists):
        g = wfr_sweep_spatial(img0, wlist, pk, sigma, mesh, axis=axis,
                              spectrum=spectrum)
        lock = g["lockin"]
        phs.append(jnp.arctan2(lock.imag, lock.real).astype(rdt))
        wts.append(jnp.sqrt(g["absq"]) * mask)
    phases_demod = jnp.stack(phs)
    weights = jnp.stack(wts)
    return reconstruct_u_inv_from_demod_sharded(
        jnp.asarray(kvecs_h, rdt), phases_demod, weights, mesh,
        axis=axis, kmax=kmax, unwrap_coarse=unwrap_coarse)
