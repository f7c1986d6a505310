"""Sharded GPA pipelines.

Two axes of parallelism, composable on one mesh:

 - batch ("dp"): a stack of images (LEEM mosaic tiles, time series) is
   sharded over the mesh's batch axis; the whole per-image pipeline
   (WFR sweeps -> lstsq -> CG unwrap) runs as one SPMD program, no
   cross-image communication.
 - k-sweep ("candidate parallel"): the WFR candidate grid of a single
   large image is split across devices; each device sweeps its slice
   against the (replicated) image spectrum, then the per-pixel argmax
   is combined with pmax/psum collectives — the device-mesh analogue of the
   reference's dask-chunked wfr2_only_lockin_vec
   (/root/reference/pyGPA/geometric_phase_analysis.py:705-719).
"""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.wfr import _wfr_sweep_chunked
from ..ops.lockin import plane_wave
from ..core.mathtools import wrap_to_pi
from ..gpa.pipeline import extract_displacement_field


def wfr_sweep_sharded(image, wlist, kref, sigma, mesh, axis="batch",
                      with_grad=False, chunk=8):
    """WFR sweep with the candidate grid sharded over `axis` of `mesh`.

    Each device runs the single-FFT chunked sweep on its candidate
    slice; winners combine through an O(1)-memory argmax tree: pmax
    picks the winning amplitude, the lowest device index claiming it
    breaks ties (preserving the reference's sequential first-max
    semantics for the row-major grid), and psum gathers the winner's
    fields. Returns the same dict as ops.wfr.wfr_sweep.
    """
    n_dev = mesh.shape[axis]
    image = jnp.asarray(image)
    wlist = np.asarray(wlist)
    P_cand = wlist.shape[0]
    pad = (-P_cand) % n_dev
    wpad = np.full((pad, 2), 1e3, wlist.dtype)
    wl = np.concatenate([wlist, wpad]).reshape(n_dev, -1, 2)
    per_dev = wl.shape[1]
    rdt = image.dtype

    spectrum = jnp.fft.fft2(image - image.mean())

    def local_sweep(spec, wslice):
        ws = wslice.reshape(per_dev, 2)
        best_absq, best_lockin, best_idx, best_grad = _wfr_sweep_chunked(
            spec, ws, float(sigma), with_grad,
            int(min(chunk, per_dev)))
        if not with_grad:
            best_grad = jnp.zeros(spec.shape + (2,), rdt)
        gmax = jax.lax.pmax(best_absq, axis)
        my_id = jax.lax.axis_index(axis)
        claim = jnp.where(best_absq == gmax, my_id, n_dev)
        winner = jax.lax.pmin(claim, axis)
        mine = winner == my_id
        lockin = jax.lax.psum(
            jnp.where(mine, best_lockin, jnp.zeros((), best_lockin.dtype)),
            axis)
        idx = jax.lax.psum(
            jnp.where(mine, best_idx + my_id * per_dev, 0), axis)
        grad = jax.lax.psum(jnp.where(mine[..., None], best_grad, 0.0),
                            axis)
        return lockin[None], idx[None], grad[None]

    lockin, idx, grad = shard_map(
        local_sweep, mesh=mesh,
        in_specs=(P(None, None), P(axis, None, None)),
        out_specs=(P(axis, None, None), P(axis, None, None),
                   P(axis, None, None, None)),
        # the scan carry inside the sweep kernel starts unvarying and
        # becomes device-varying after the first chunk; replica
        # consistency is established explicitly via pmax/psum below
        check_vma=False,
    )(spectrum, jnp.asarray(wl))
    lockin, idx, grad = lockin[0], idx[0], grad[0]
    kref = jnp.asarray(kref, rdt)
    out = {
        "lockin": lockin * plane_wave(image.shape, kref, rdt),
        "w": jnp.moveaxis(jnp.asarray(wl.reshape(-1, 2), rdt)[idx], -1, 0),
    }
    if with_grad:
        g = grad - 2 * jnp.pi * kref
        out["grad"] = wrap_to_pi(2.0 * g) / 2.0
    return out


def extract_displacement_field_batch(images, kvecs, mesh=None,
                                     axis="batch", **kwargs):
    """Displacement fields for a stack of images, batch-sharded over
    the mesh: vmap of the full pipeline under jit with a batch
    sharding — the device-mesh equivalent of mapping the pipeline over
    dask-chunked mosaic tiles."""
    images = jnp.asarray(images)
    kvecs = np.asarray(kvecs)

    def one(img):
        return extract_displacement_field(img, kvecs, **kwargs)

    fn = jax.vmap(one)
    if mesh is not None:
        sh = NamedSharding(mesh, P(axis, None, None))
        images = jax.device_put(images, sh)
        out_sh = NamedSharding(mesh, P(axis))
        return jax.jit(fn, out_shardings=out_sh)(images)
    return jax.jit(fn)(images)
