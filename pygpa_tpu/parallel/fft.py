"""Distributed 2D FFT and spatially-sharded WFR sweep.

For single images that exceed one device's memory comfort (8k^2+ complex
intermediates; SURVEY.md 'Multi-device scaling'), the image stays
ROW-SHARDED over the mesh for its whole lifetime:

 - fft2_sharded / ifft2_sharded: classic pencil decomposition. Each
   device FFTs its full local rows along the minor axis, one
   all_to_all re-pencils the array column-sharded, the major
   axis is FFT'd locally, and a second all_to_all restores row
   sharding. No device ever holds the full array.
 - wfr_sweep_spatial: the zoom-window WFR sweep with the OUTPUT rows
   sharded: the bandpassed spectrum window (W0 x W1, tiny) is
   replicated via all_gather of the owning shards' window rows, and
   each device then computes only its own row block of every
   candidate plane with the zoom matmuls — embarrassingly parallel in
   rows, so the argmax carries never cross devices.

Everything is shard_map + jnp; the inner zoom matmuls use the
single-device sweep's bases and precision (ops/wfr.py).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.wfr import _ZOOM_PRECISION, _plan_zoom, _zoom_basis


def _fft_local(x, axis, inverse):
    f = jnp.fft.ifft if inverse else jnp.fft.fft
    return f(x, axis=axis)


def _fft2_pencil(x_local, axis_name, n_dev, inverse):
    """Local (n/D, m) block -> 2D-FFT'd local block, row-sharded."""
    # 1) minor axis: rows are complete locally
    x_local = _fft_local(x_local, -1, inverse)
    # 2) re-pencil: split columns into D chunks, gather all row blocks
    #    -> (n, m/D) with full columns local
    x_t = jax.lax.all_to_all(x_local, axis_name, split_axis=1,
                             concat_axis=0, tiled=True)
    x_t = _fft_local(x_t, -2, inverse)
    # 3) restore row sharding
    return jax.lax.all_to_all(x_t, axis_name, split_axis=0,
                              concat_axis=1, tiled=True)


def fft2_sharded(image, mesh, axis="batch", inverse=False):
    """2D (i)FFT of a row-sharded image on a device mesh; returns the
    row-sharded transform. The input may be real (forward) or complex;
    output is complex, laid out P(axis, None)."""
    n_dev = mesh.shape[axis]
    image = jnp.asarray(image)
    n, m = image.shape
    assert n % n_dev == 0 and m % n_dev == 0, (
        "pencil FFT needs both axes divisible by the mesh axis")
    cdt = jnp.result_type(image.dtype, jnp.complex64)

    fn = shard_map(
        partial(_fft2_pencil, axis_name=axis, n_dev=n_dev,
                inverse=inverse),
        mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None))
    sh = NamedSharding(mesh, P(axis, None))
    return fn(jax.device_put(image.astype(cdt), sh))


def ifft2_sharded(spectrum, mesh, axis="batch"):
    return fft2_sharded(spectrum, mesh, axis=axis, inverse=True)


def wfr_sweep_spatial(image, wlist, kref, sigma, mesh, axis="batch",
                      chunk=8, spectrum=None):
    """WFR zoom sweep of ONE image with the image/output rows sharded
    over the mesh — for images whose (N, M) planes are too large to
    replicate per chip.

    The spectrum is computed with the pencil FFT (staying sharded);
    each device all_gathers only the tiny (W0, W1) bandpass window and
    sweeps its own row block of all candidates. Returns the sharded
    demodulated lock-in and absq planes (P(axis, None)), matching
    wfr_sweep(..., rebase=False, return_absq=True).
    """
    n_dev = mesh.shape[axis]
    image = jnp.asarray(image)
    n, m = image.shape
    rdt = jnp.finfo(image.dtype).dtype if jnp.issubdtype(
        image.dtype, jnp.floating) else jnp.float32
    wl = np.asarray(wlist)
    plan = _plan_zoom((n, m), wl, float(sigma))
    assert plan is not None, "window too large for the zoom sweep"
    idx0, idx1 = plan

    if spectrum is None:
        spectrum = fft2_sharded(image - image.mean(), mesh, axis=axis)

    rows_per = n // n_dev
    # map global window row indices to (device, local row)
    owner = idx0 // rows_per
    local = idx0 % rows_per

    s2 = 2.0 * np.pi ** 2 * float(sigma) ** 2
    f0 = np.where(idx0 < n // 2 + n % 2, idx0, idx0 - n).astype(
        np.float64) / n
    f1 = np.where(idx1 < m // 2 + m % 2, idx1, idx1 - m).astype(
        np.float64) / m
    gx_all = jnp.asarray(
        np.exp(-s2 * (f0[None, :] + wl[:, 0:1]) ** 2).astype(rdt))
    gy_all = jnp.asarray(
        np.exp(-s2 * (f1[None, :] + wl[:, 1:2]) ** 2).astype(rdt))
    A1c, A1s = _zoom_basis(m, jnp.asarray(idx1), rdt)   # (m, W1)
    scale = 1.0 / (n * m)

    def sweep_rows(S, dev):
        r0 = dev * rows_per
        r = (jnp.arange(rows_per, dtype=jnp.int32) + r0)[:, None]
        ph = (r * jnp.asarray(idx0)[None, :]) % n
        ang = (2 * jnp.pi / n) * ph.astype(rdt)
        A0c, A0s = jnp.cos(ang), jnp.sin(ang)           # (n/D, W0)
        Sr = S.real.astype(rdt) * scale
        Si = S.imag.astype(rdt) * scale
        hi = _ZOOM_PRECISION

        def body(ci, carry):
            best_absq, best_r, best_i, best_idx = carry
            gx = gx_all[ci]
            gy = gy_all[ci]
            Swr = gx[:, None] * Sr * gy[None, :]
            Swi = gx[:, None] * Si * gy[None, :]
            Tr = (jnp.einsum("rw,wv->rv", A0c, Swr, precision=hi)
                  - jnp.einsum("rw,wv->rv", A0s, Swi, precision=hi))
            Ti = (jnp.einsum("rw,wv->rv", A0c, Swi, precision=hi)
                  + jnp.einsum("rw,wv->rv", A0s, Swr, precision=hi))
            Mr = (jnp.einsum("rv,sv->rs", Tr, A1c, precision=hi)
                  - jnp.einsum("rv,sv->rs", Ti, A1s, precision=hi))
            Mi = (jnp.einsum("rv,sv->rs", Tr, A1s, precision=hi)
                  + jnp.einsum("rv,sv->rs", Ti, A1c, precision=hi))
            absq = Mr * Mr + Mi * Mi
            sel = absq > best_absq
            return (jnp.where(sel, absq, best_absq),
                    jnp.where(sel, Mr, best_r),
                    jnp.where(sel, Mi, best_i),
                    jnp.where(sel, ci, best_idx))

        # the carries become device-varying inside the loop
        init = jax.lax.pcast(
            (jnp.zeros((rows_per, m), rdt), jnp.zeros((rows_per, m), rdt),
             jnp.zeros((rows_per, m), rdt),
             jnp.zeros((rows_per, m), jnp.int32)), (axis,), to="varying")
        best_absq, best_r, best_i, best_idx = jax.lax.fori_loop(
            0, wl.shape[0], body, init)
        return best_absq, best_r, best_i, best_idx

    def body(spec_local):
        dev = jax.lax.axis_index(axis)
        mine = (owner == dev)
        rows = jnp.where(mine[:, None],
                         spec_local[jnp.asarray(local), :][
                             :, jnp.asarray(idx1)],
                         jnp.zeros((idx0.size, idx1.size),
                                   spec_local.dtype))
        # psum component-wise (complex collectives are not universally
        # lowered)
        S = jax.lax.complex(jax.lax.psum(rows.real, axis),
                            jax.lax.psum(rows.imag, axis))
        best_absq, best_r, best_i, best_idx = sweep_rows(S, dev)
        lock = jax.lax.complex(best_r, best_i)
        return best_absq, lock, best_idx

    fn = shard_map(body, mesh=mesh, in_specs=P(axis, None),
                   out_specs=(P(axis, None), P(axis, None),
                              P(axis, None)))
    best_absq, lockin, best_idx = fn(spectrum)
    return {"lockin": lockin, "absq": best_absq, "idx": best_idx}
