"""pygpa_tpu quickstart: full GPA workflow on a synthetic twisted
bilayer, end to end.

Run: python examples/quickstart.py          (GPU if available)
     JAX_PLATFORMS=cpu python examples/quickstart.py   (CPU)
"""
import numpy as np
import jax.numpy as jnp

import pygpa_tpu as gt


def main():
    # --- synthesize a deformed moire lattice with known ground truth
    size = 512
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S),
                         indexing="ij")
    u_true = np.stack([2.0 * np.exp(-((xp / 120.) ** 2
                                      + (yp / 90.) ** 2)),
                       np.zeros((size, size))])
    u_true -= u_true.mean(axis=(1, 2), keepdims=True)
    r_k, theta = 0.07, 12.0
    image = gt.lattices.hexlattice_gen(r_k, theta, order=2, size=size,
                                       shift=u_true)
    print(f"image: {image.shape} {image.dtype}")

    # --- 1. detect the Bragg/moire peaks (sub-bin refinement), then
    #        refine to sub-grid accuracy with the iterate_GPA loop
    pks, _ = gt.gpa.extract_primary_ks(np.asarray(image), DoG=False,
                                       subpixel=True)
    ks = gt.gpa.refine_ks(image, pks)
    print("refined ks:\n", np.round(ks, 5))

    # --- 2. extract the displacement field (WFR sweep + unwrap)
    u = -np.asarray(gt.gpa.extract_displacement_field(
        image, ks, deconvolve=True))
    err = np.abs(u - u_true)[:, 20:-20, 20:-20]
    print(f"displacement error vs truth: max {err.max():.3f} px")

    # --- 3. undistort (Lawler-Fujita)
    flat = gt.gpa.undistort_image(image, jnp.asarray(u_true),
                                  coarse=4)
    clean = gt.lattices.hexlattice_gen(r_k, theta, order=2, size=size)
    rel = (np.abs(np.asarray(flat) - np.asarray(clean))
           / np.abs(np.asarray(clean)).max())
    print(f"undistortion rel err: interior max {rel[10:-10, 10:-10].max():.4f}"
          " (outermost pixels blend with the fill value)")

    # --- 4. local lattice properties
    props = np.asarray(gt.props.calc_props_from_kvecs4(ks,
                                                       standardize=True))
    print(f"lattice props: theta={props[0]:.2f} deg (mod 60), "
          f"psi={props[1]:.1f} deg, r_k={props[2]:.4f}, "
          f"kappa={props[3]:.4f}")

    # per-pixel property maps from the displacement field (plane layout)
    maps = np.asarray(gt.props.props_from_u(jnp.asarray(u), 1.0))
    print(f"local twist map: shape {maps[0].shape}, "
          f"range {maps[0].min():.3f}..{maps[0].max():.3f} deg")

    # --- 5. unit-cell average
    cell = gt.ucell.unit_cell_average(np.asarray(image), ks[:2],
                                      u=jnp.asarray(u_true), z=2)
    print(f"unit cell: {np.asarray(cell).shape}")

    # --- production: one fused executable for a fixed shape/k-set
    fn = gt.gpa.pipeline.make_displacement_extractor((size, size), ks)
    u_fast = fn(image)
    print(f"fused pipeline output: {u_fast.shape} {u_fast.dtype}")


if __name__ == "__main__":
    main()
