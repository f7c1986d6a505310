"""The BASELINE.json benchmark configs, one JSON line each, on one GPU.

    python benchmarks/run_all.py [--configs 1,1b,2,2g,3,4,5,5f,6]

bench.py at the repo root remains the headline single-line metric
(full pipeline at 4096^2); this suite covers the whole BASELINE grid:
 1. 512^2 hexagonal lattice, fixed ks: basic GPA + displacement field
 2. 1024^2 small-angle moire: WFR reference-vector sweep pipeline
 3. 2048^2 distorted lattice: weighted unwrap + Lawler-Fujita
 4. 4096^2 TBG moire: unit-cell averaging + full-image reconstruction
 5. 8k^2 mosaic as 4x(4096^2) tiles: batched property extraction
 6. 8192^2 single image, full pipeline on one card

Every config carries a HARD accuracy gate (same discipline as
bench.py's headline gates): each fixture embeds a known truth — zero
displacement, an analytic plane, a perfect periodic lattice, an affine
distortion with known global properties — and the config asserts the
relevant error bound BEFORE printing a number, so no config can trade
accuracy for speed silently. A failed gate makes the script exit
non-zero. It needs a GPU and prints the card's name and power limit in
every line.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def _timeit(fn, *args, reps=3):
    """Seconds per call: one warm call, then `reps` calls ending in
    block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _interior_umax(u, ks, mult=8):
    """max |u| over the rim-trimmed interior of a displacement field
    recovered from a ZERO-displacement fixture (the fixture's ks match
    the rendered lattice exactly, so |u| IS the pipeline error)."""
    import jax.numpy as jnp
    b = mult * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    return float(jnp.max(jnp.abs(u[..., b:-b, b:-b])))


def config1():
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    size = 512
    img = hexlattice_gen(0.1, 7.0, order=2, size=size, dtype=jnp.float32)
    ks = np.asarray(generate_ks(0.1, 7.0))[:3]
    fn = make_displacement_extractor((size, size), ks,
                                     unwrap_coarse=4)
    dt = _timeit(fn, img)
    checks = {"u_err_interior_px": (_interior_umax(fn(img), ks), 0.02)}
    return ("basic GPA + displacement field, 512^2",
            size * size / 1e6 / dt, checks)

def config1b():
    """Batched config 1: 16 images through one vmapped executable (the
    reference analogue is dask-mapping the pipeline over an image
    stack)."""
    import jax
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    size, nb = 512, 16
    # distinct batch members via CONSTANT sub-pixel lattice shifts
    # baked into the render (NOT jnp.roll: the lattice does not tile
    # the frame, so a circular roll leaves a wrap seam whose phase
    # step corrupts the whole unwrapped field). A constant shift is an exact translated lattice; the
    # recovered field is that constant, so the per-image dc-free
    # residual is the pipeline error.
    imgs = [np.asarray(hexlattice_gen(
        0.1, 7.0, order=2, size=size,
        shift=np.full((2, size, size), 0.31 * i, np.float32),
        dtype=jnp.float32)) for i in range(nb)]
    batch = jnp.asarray(np.stack(imgs))
    ks = np.asarray(generate_ks(0.1, 7.0))[:3]
    fn = make_displacement_extractor((size, size), ks, unwrap_coarse=4)
    vfn = jax.jit(jax.vmap(fn))
    dt = _timeit(vfn, batch)
    ub = vfn(batch)
    ub = ub - ub.mean(axis=(-1, -2), keepdims=True)
    checks = {"u_err_interior_dcfree_px": (_interior_umax(ub, ks),
                                           0.02)}
    return ("basic GPA + displacement field, 512^2 x16 batched",
            nb * size * size / 1e6 / dt, checks)


def config2():
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    size = 1024
    r_k = 0.015  # small-angle moire
    img = hexlattice_gen(r_k, 3.0, order=2, size=size, dtype=jnp.float32)
    ks = np.asarray(generate_ks(r_k, 3.0))[:3]
    fn = make_displacement_extractor((size, size), ks,
                                     unwrap_coarse=4)
    dt = _timeit(fn, img)
    # the small-angle fixture is boundary-limited: sigma=67 on a
    # 1024^2 image leaves the lock-in window ~6.5% of the frame, so
    # window/boundary ripple reaches deep into the interior (NOT a DC
    # artifact; the reference's own noisy-fixture tolerance for this
    # class is 0.9 px). The gate catches catastrophic breaks (garbage
    # >> 1 px), not sub-0.1-px drift — config 1/1b and the bench
    # headline own that regime.
    checks = {"u_err_interior_px": (_interior_umax(fn(img), ks, mult=2),
                                    0.6)}
    return ("WFR sweep pipeline, 1024^2 small-angle moire",
            size * size / 1e6 / dt, checks)

def config2g():
    """Adaptive-GPA property extraction from WFR phase GRADIENTS (the
    reference's wfr2_grad_opt + property chain, property_extract.py:
    234-255 / cuGPA.py:41-87): 3 grad sweeps -> phasegradient2Jac ->
    local (theta, kappa, ...) maps, 4096^2."""
    import jax
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.ops.wfr import wfr_sweep_phase_weight_multi
    from pygpa_tpu.props.jacobians import calc_props_from_phasegradient
    size = 4096
    r_k = 0.02
    theta0 = 5.0
    img = hexlattice_gen(r_k, theta0, order=2, size=size,
                         kappa=1.005, psi=10.0, dtype=jnp.float32)
    ks = np.asarray(generate_ks(r_k, theta0, kappa=1.005, psi=10.0))[:3]
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    sigma = int(np.ceil(1 / knorms.min()))
    wlists = []
    for pk in ks:
        wxs = np.arange(pk[0] - kw, pk[0] + kw, kw / 3)
        wys = np.arange(pk[1] - kw, pk[1] + kw, kw / 3)
        wx, wy = np.meshgrid(wxs, wys, indexing="ij")
        wlists.append(np.stack([wx.ravel(), wy.ravel()], -1))
    kv = jnp.asarray(ks, jnp.float32)

    @jax.jit
    def step(image):
        img0 = image - image.mean()
        _, weights, grads = wfr_sweep_phase_weight_multi(
            img0, wlists, sigma, 2 * sigma,
            with_grad=True, krefs=ks)
        return calc_props_from_phasegradient(kv, grads, weights, 1.0)

    dt = _timeit(step, img)
    # the fixture's distortion is globally AFFINE (ks rendered with
    # kappa/psi baked in, sweep krefs = those same ks), so every local
    # property map must be spatially constant: props[0] is the local
    # angle offset map (exactly theta_0 for an undistorted-in-moire-
    # frame lattice) and props[3] the anisotropy magnitude (exactly 1)
    from pygpa_tpu.props.jacobians import get_initial_props
    props = step(img)
    # 4*sigma crop: at 2*sigma the lock-in window rim still
    # contaminates the derivative-based maps. The anisotropy map must
    # equal the fixture's BAKED kappa (the sweep krefs carry the
    # anisotropic ks; the isotropic-reference rebase recovers kappa =
    # 1.005) — not 1.0.
    b = 4 * sigma
    th = props[0][b:-b, b:-b]
    ka = props[3][b:-b, b:-b]
    _, expect_th, _ = get_initial_props(ks)
    checks = {
        "theta_err_interior_deg": (
            float(jnp.max(jnp.abs(th - jnp.float32(expect_th)))), 0.01),
        "kappa_err_interior": (
            float(jnp.max(jnp.abs(ka - 1.005))), 0.001),
    }
    return ("adaptive GPA props from phase gradients, 4096^2",
            size * size / 1e6 / dt, checks)


def config3():
    import jax
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen
    from pygpa_tpu.solvers.unwrap import phase_unwrap_mg
    from pygpa_tpu.gpa.pipeline import undistort_image
    size = 2048
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S),
                         indexing="ij")
    u = np.stack([3.0 * np.exp(-((xp / 400.) ** 2 + (yp / 500.) ** 2)),
                  np.zeros((size, size))]).astype(np.float32)
    img = hexlattice_gen(0.08, 5.0, order=2, size=size,
                         shift=u, dtype=jnp.float32)
    clean = jnp.asarray(hexlattice_gen(0.08, 5.0, order=2, size=size,
                                       dtype=jnp.float32))
    uj = jax.device_put(jnp.asarray(u))
    psi = jnp.asarray((0.05 * np.asarray(xp + yp)).astype(np.float32))
    w = jnp.abs(img)

    @jax.jit
    def step(img, uj, psi, w):
        # production multigrid unwrap: on this fixture it lands ~7x
        # closer to the converged solution than 25 plain CG iterations
        # (0.12 vs 0.89 rad max vs a 200-iteration reference) — the
        # weighted Poisson system of lock-in weights is badly
        # conditioned
        phi = phase_unwrap_mg(psi, w)
        rec = undistort_image(img, uj, coarse=4)
        return phi, rec

    dt = _timeit(step, img, uj, psi, w)
    # truths: the unwrap input is an analytic PLANE (no wraps in its
    # diffs), so phi must reproduce it up to the unwrap's free
    # constant; the undistort inverts the exact u that rendered the
    # image, so rec must reproduce the clean lattice up to B-spline
    # interpolation error
    phi, rec = step(img, uj, psi, w)
    dphi = phi - psi
    dphi = dphi - jnp.mean(dphi)
    b = 32
    rerr = (rec - clean)[b:-b, b:-b]
    # the lattice-amplitude weights have near-zero nodes where the mg
    # solve legitimately leaves point residual (consistent with the
    # documented 0.12 rad mg-vs-converged bound in
    # solvers/unwrap.phase_unwrap_mg). Gate the bulk via p99 and the
    # tail loosely.
    checks = {
        "unwrap_plane_err_p99_rad": (
            float(jnp.percentile(jnp.abs(dphi), 99.0)), 0.02),
        "unwrap_plane_err_max_rad": (float(jnp.max(jnp.abs(dphi))), 0.3),
        "undistort_rel_rms": (
            float(jnp.sqrt(jnp.mean(rerr * rerr))
               / jnp.sqrt(jnp.mean(clean * clean))), 0.05),
    }
    return ("weighted unwrap + Lawler-Fujita (coarse inversion), "
            "2048^2", size * size / 1e6 / dt, checks)

def config4():
    import jax
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.ucell import unit_cell_average, expand_unitcell
    size = 4096
    r_k = 0.02
    img = hexlattice_gen(r_k, 5.0, order=2, size=size, dtype=jnp.float32)
    ks2 = np.asarray(generate_ks(r_k, 5.0))[:2]
    avg = unit_cell_average(None, ks2, z=2, only_generate_func=True)

    @jax.jit
    def step(img):
        cell = avg(img)
        rec = expand_unitcell(cell, ks2, (size, size), z=2)
        return rec

    dt = _timeit(step, img)
    # the fixture is a PERFECT periodic lattice, so the average-cell
    # reconstruction must reproduce it (interior; drizzle rim excluded)
    rec = step(img)
    b = 128
    d = (rec - img)[b:-b, b:-b]
    ref = img[b:-b, b:-b]
    checks = {"ucell_roundtrip_rel_rms": (
        float(jnp.sqrt(jnp.mean(d * d)) / jnp.sqrt(jnp.mean(ref * ref))),
        0.05)}
    return ("unit-cell average + reconstruction, 4096^2",
            size * size / 1e6 / dt, checks)

def config5():
    import jax
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    from pygpa_tpu.props.jacobians import props_from_u
    # 8k^2 mosaic = 4 tiles of 4096^2, vmapped
    tile = 4096
    r_k = 0.02
    img = hexlattice_gen(r_k, 5.0, order=2, size=tile, dtype=jnp.float32)
    tiles = jnp.stack([img, img[::-1], img[:, ::-1], img[::-1, ::-1]])
    ks = np.asarray(generate_ks(r_k, 5.0))[:3]
    extract = make_displacement_extractor((tile, tile), ks, chunk=4,
                                          unwrap_coarse=4)

    @jax.jit
    def step(tiles):
        def one(t):
            u = extract(t)
            return props_from_u(u, 1.0)
        return jax.lax.map(one, tiles)

    dt = _timeit(step, tiles, reps=2)
    # tile 0 is the unflipped perfect lattice: u == 0, so its local
    # angle-offset map must be the constant theta_0 and the
    # anisotropy magnitude exactly 1 (props are derivative-based, so
    # this bounds the recovered u's GRADIENT error, complementing the
    # |u| gates of configs 1/2)
    props = step(tiles)
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    th = props[0, 0][b:-b, b:-b]
    ka = props[0, 3][b:-b, b:-b]
    # props_from_u has no k-vector reference, so its angle map is the
    # local angle OFFSET — ~0 for the undistorted tile
    checks = {
        "theta_offset_interior_deg": (
            float(jnp.max(jnp.abs(th))), 0.01),
        "kappa_err_interior": (float(jnp.max(jnp.abs(ka - 1.0))), 0.001),
    }
    return ("batched property extraction, 8k^2 mosaic (4 tiles)",
            4 * tile * tile / 1e6 / dt, checks)


def config5f():
    """Per-pixel Kerelsky J-field fit throughput (iterate_J_leastsq):
    the reference maps scipy least_squares over a dask gufunc
    (property_extract.py:863-883); here every pixel's two-start LM is
    one vmapped device program. Unit: Mpix/s of fitted pixels."""
    import jax
    import jax.numpy as jnp
    from pygpa_tpu.lattices import generate_ks
    from pygpa_tpu.props.kerelsky import (Kerelsky_Jac, _jac_a0,
                                          iterate_J_leastsq)
    kvecs = np.asarray(generate_ks(0.02, 1.2))[:3]
    refest = Kerelsky_Jac(kvecs)
    _, A0 = _jac_a0(kvecs, 1.0, 0.246, 0)
    n = 128
    xg, yg = np.meshgrid(np.linspace(0, 2 * np.pi, n),
                         np.linspace(0, 2 * np.pi, n), indexing="ij")
    pert = 1e-3 * np.stack(
        [np.sin(xg), np.cos(yg), np.sin(xg + yg), np.cos(xg - yg)],
        axis=-1).reshape(n, n, 2, 2)
    JacA0s = jnp.asarray(A0[None, None] + pert, jnp.float32)
    fn = jax.jit(lambda J: iterate_J_leastsq(J, jnp.asarray(
        refest, jnp.float32)))
    dt = _timeit(fn, JacA0s, reps=2)
    # the field is A0 + a 1e-3 perturbation, so every pixel's fitted
    # (theta, psi, eps, xi) must stay near the unperturbed solution
    # refest — a diverged or unconverged LM shows up as a large
    # per-pixel angle deviation
    X = fn(JacA0s)
    checks = {"fit_theta_dev_deg": (
        float(jnp.max(jnp.abs(X[..., 0] - jnp.float32(float(refest[0]))))),
        0.5)}
    # kfits/s: each "pixel" is a full two-start 60-iteration LM fit
    # (the reference analogue is one scipy least_squares call per
    # pixel through a dask gufunc, ~ms each on CPU)
    return ("Kerelsky J-field per-pixel LM fits, 128^2 (kfits/s)",
            n * n / 1e3 / dt, checks)


def config6():
    """8192^2 SINGLE image through the full pipeline on one card:
    extends the single-card story past 4096^2 (beyond one card's
    memory, extract_displacement_field_sharded takes over). Same
    physics as the headline fixture (r_k=0.02, sigma=50), so per-pixel
    sweep work ~doubles (spectrum windows span 2x the FFT indices at
    the same k-extent)."""
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    size = 8192
    img, _, _, ks = bench.headline_fixtures(size)
    fn = make_displacement_extractor((size, size), ks, chunk=4,
                                     unwrap_coarse=4)
    dt = _timeit(fn, img, reps=2)
    # the interior ripple + unwrap DC grow with image size (the
    # integration of low-frequency gradient noise grows ~linearly in
    # the domain); u is determined up to a constant, so the dc-free
    # ripple is gated separately
    raw, dcfree = bench.interior_errors(fn(img), ks)
    checks = {
        "u_err_interior_px": (raw, CONFIG6_GATES["u_err_interior_px"]),
        "u_err_interior_dcfree_px": (
            dcfree, CONFIG6_GATES["u_err_interior_dcfree_px"]),
    }
    return ("full pipeline, 8192^2 single image",
            size * size / 1e6 / dt, checks)


# config 6's accuracy gates (px); chip_smoke.py applies them too
CONFIG6_GATES = {"u_err_interior_px": 0.004,
                 "u_err_interior_dcfree_px": 0.003}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--configs", default="1,1b,2,2g,3,4,5,5f,6")
    args = p.parse_args()
    bench.use_repo_compile_cache()
    devs = bench.require_gpu()
    card = bench.card_name_and_power()
    print(card, flush=True)
    fns = {"1": config1, "1b": config1b, "2": config2, "2g": config2g,
           "3": config3, "4": config4, "5": config5, "5f": config5f,
           "6": config6}
    failed = []
    for c in args.configs.split(","):
        name, val, checks = fns[c]()
        unit = "kfits/s" if "kfits" in name else "Mpix/s"
        rec = {"config": c, "metric": name, "value": val, "unit": unit,
               "device": bench.device_record(devs), "card": card}
        bad = {k: (v, bound) for k, (v, bound)
               in checks.items() if not v < bound}
        for k, (v, bound) in checks.items():
            rec[k] = v
            rec[f"gate_{k}"] = bound
        if bad:
            rec["metric"] = "ACCURACY GATE FAILED: " + name
            rec["value"] = 0.0
            rec["failed_checks"] = bad
            failed.append(c)
        print(json.dumps(rec), flush=True)
    if failed:
        raise SystemExit(f"accuracy gates failed: configs {failed}")


if __name__ == "__main__":
    main()
