"""Multi-device GPA: shard a LEEM-style mosaic over a device mesh.

Demonstrates the three parallel axes of pygpa_tpu.parallel:
 1. data-parallel batch of mosaic tiles (extract_displacement_field_batch)
 2. candidate-parallel WFR sweep of one image (wfr_sweep_sharded)
 3. row-sharded single-image path for images larger than one device's
    memory: pencil-decomposed distributed FFT + spatially-sharded sweep

Runs anywhere: on a multi-GPU host it uses the real mesh; on CPU,
launch with a virtual mesh, e.g.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/mosaic_sharded.py
"""
import numpy as np
import jax
import jax.numpy as jnp

import pygpa_tpu as gt
from pygpa_tpu.parallel import (make_mesh, extract_displacement_field_batch,
                                wfr_sweep_sharded, fft2_sharded,
                                wfr_sweep_spatial)


def main():
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, ("batch",))
    print(f"mesh: {n_dev} x {jax.devices()[0].platform}")

    r_k, theta, size = 0.1, 7.0, 256
    img = np.asarray(gt.lattices.hexlattice_gen(r_k, theta, order=2,
                                                size=size,
                                                dtype=np.float32))
    ks = np.asarray(gt.lattices.generate_ks(r_k, theta))[:3]

    # 1 --- data parallel: one mosaic tile per device
    tiles = np.stack([np.roll(img, 3 * i, axis=0)
                      for i in range(n_dev)])
    us = extract_displacement_field_batch(tiles, ks, mesh=mesh)
    print("batch displacement fields:", us.shape)
    # per-tile property maps (twist / strain) from the u fields
    props = jax.vmap(lambda u: gt.props.props_from_u(u, 1.0))(us)
    print("per-tile property maps:", jax.tree.map(jnp.shape, props))

    # 2 --- candidate parallel: one image's WFR k-sweep over the mesh
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    wxs = np.arange(ks[0, 0] - kw, ks[0, 0] + kw, kw / 3)
    wys = np.arange(ks[0, 1] - kw, ks[0, 1] + kw, kw / 3)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    wlist = np.stack([wx.ravel(), wy.ravel()], -1)
    g = wfr_sweep_sharded(jnp.asarray(img), wlist, ks[0],
                          int(np.ceil(1 / knorms.min())), mesh=mesh)
    print("sharded sweep lock-in:", g["lockin"].shape)

    # 3 --- spatial sharding: image rows stay distributed end to end
    spec = fft2_sharded(jnp.asarray(img), mesh)
    print("pencil-FFT spectrum sharding:", spec.sharding)
    gs = wfr_sweep_spatial(jnp.asarray(img), wlist, ks[0],
                           int(np.ceil(1 / knorms.min())), mesh=mesh)
    print("row-sharded sweep absq:", gs["absq"].shape,
          gs["absq"].sharding)


if __name__ == "__main__":
    main()
