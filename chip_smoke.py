"""Bring-up check of the GPA pipeline on one GPU.

Runs in ONE process; its only child process is nvidia-smi.

    python chip_smoke.py             # one GPU: phases 1-3
    python chip_smoke.py --four      # four GPUs: the parallel/ paths only
    python chip_smoke.py --rehearse  # tiny sizes on any platform (CPU)

Phases:
 1. Device: refuse any platform but "gpu" (unless --rehearse); print the
    device kind and count and nvidia-smi's name and power limit.
 2. Main path at full width: make_displacement_extractor on the 4096^2
    bench.py fixtures (compile time, memory analysis, timed calls, the
    three bench.py accuracy gates) and once at 8192^2 (memory analysis,
    benchmarks/run_all.py config-6 gates).
 3. Stages against a float64 host reference (NumPy/scipy) at real
    widths, each with its time on the device: the WFR sweep, the DCT
    pair, the multigrid unwrap, map_coordinates and the unit-cell
    average + expansion.
 4. (--four only) batch-, candidate- and row-sharded pipelines on four
    devices against the one-device results.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no
such line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))
sys.path.insert(0, os.path.join(HERE, "benchmarks"))

import bench  # noqa: E402  (shared fixtures, gates, device helpers)
import pygpa_tpu  # noqa: E402,F401  (fail early outside the repo)
from run_all import CONFIG6_GATES  # noqa: E402
from pygpa_tpu.gpa.api import _wgrid  # noqa: E402

# sizes of each phase; --rehearse shrinks them (and uses a finer
# lattice, so that the pipeline's 8-sigma interior stays non-empty)
FULL = dict(main=4096, big=8192, sweep=1024, dct=4096, unwrap=1024,
            interp=2048, ucell=4096, four=4096, four_big=8192,
            r_k=bench.R_K)
REHEARSE = dict(main=512, big=384, sweep=128, dct=128, unwrap=128,
                interp=128, ucell=256, four=128, four_big=256, r_k=0.16)

def log(*a):
    print(*a, flush=True)


def timed(fn, *args, reps=5):
    """Warm call, then `reps` calls that each end in block_until_ready.
    Returns (last output, list of seconds)."""
    import jax
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, ts


def fmt_ms(ts):
    return (f"median {1e3 * float(np.median(ts)):.3f} ms "
            f"(runs: {', '.join(f'{1e3 * t:.3f}' for t in ts)})")


def compile_report(name, jitted, *args):
    """Lower + compile `jitted` for `args`; print the compile time and
    the executable's memory analysis. Returns the compiled callable."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    if ma is None:
        mem = "not available"
    else:
        mem = ", ".join(
            f"{k} {getattr(ma, k + '_in_bytes') / 2 ** 20:.1f} MiB"
            for k in ("argument_size", "output_size", "temp_size",
                      "alias_size", "generated_code_size"))
    log(f"{name}: compile {dt:.2f} s; memory analysis: {mem}")
    return compiled


def check(name, value, bound, why):
    """Assert value < bound; print both and the bound's reason."""
    ok = bool(value < bound)
    log(f"  {name} = {value:.3e} (bound {bound:.1e}: {why}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value} >= {bound}")


# --- phase 1 -------------------------------------------------------------

def phase_device(rehearse, n_devices):
    import jax
    devs = jax.devices()
    if not rehearse and devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform is "
                         f"{devs[0].platform!r}); use --rehearse to "
                         f"rehearse on another platform")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} devices, "
                         f"found {len(devs)}")
    devs = devs[:n_devices]
    log(f"device: platform {devs[0].platform}, kind "
        f"{devs[0].device_kind}, count {len(devs)}")
    try:
        card = bench.card_name_and_power()
    except FileNotFoundError:
        if not rehearse:
            raise
        card = "nvidia-smi not available"
    log(f"nvidia-smi name, power.limit: {card}")
    return devs


# --- phase 2 -------------------------------------------------------------

def phase_main_path(sz):
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    n = sz["main"]
    img, img_d, u_true, ks = bench.headline_fixtures(n, r_k=sz["r_k"])
    fn = make_displacement_extractor((n, n), ks, chunk=4,
                                     unwrap_coarse=4)
    run = compile_report(f"extractor {n}^2", fn, img)
    _, ts = timed(run, img)
    log(f"extractor {n}^2 call: {fmt_ms(ts)}; "
        f"{n * n / 1e6 / float(np.median(ts)):.2f} Mpix/s")
    vals = bench.headline_gate_values(run, img, img_d, u_true, ks)
    log(f"bench.py gates at {n}^2:")
    for k, v in vals.items():
        check(k, v, bench.GATES[k], "bench.py gate")

    nb = sz["big"]
    img, _, _, ks = bench.headline_fixtures(nb, r_k=sz["r_k"])
    fn = make_displacement_extractor((nb, nb), ks, chunk=4,
                                     unwrap_coarse=4)
    run = compile_report(f"extractor {nb}^2", fn, img)
    t0 = time.perf_counter()
    u = run(img).block_until_ready()
    log(f"extractor {nb}^2 call: "
        f"{1e3 * (time.perf_counter() - t0):.3f} ms")
    raw, dcfree = bench.interior_errors(u, ks)
    log(f"run_all.py config-6 gates at {nb}^2:")
    check("u_err_interior_px", raw, CONFIG6_GATES["u_err_interior_px"],
          "config-6 gate")
    check("u_err_interior_dcfree_px", dcfree,
          CONFIG6_GATES["u_err_interior_dcfree_px"], "config-6 gate")


# --- phase 3 -------------------------------------------------------------

def stage_sweep(sz):
    """Per-peak WFR sweep vs tests/reference_impls.ref_wfr (literal
    modulate -> FFT -> Gaussian -> IFFT per candidate, float64)."""
    import jax
    import jax.numpy as jnp
    from reference_impls import ref_wfr
    from pygpa_tpu.ops.wfr import wfr_sweep, wfr_sweep_phase_weight_multi
    from pygpa_tpu.gpa.pipeline import pipeline_candidate_grids
    n = sz["sweep"]
    img, _, _, ks = bench.headline_fixtures(n, r_k=sz["r_k"])
    img = np.asarray(img, np.float64)
    img -= img.mean()
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    kstep = kw / 3
    sigma = int(np.ceil(1 / knorms.min()))
    k = ks[0]
    wlist = _wgrid(k[0], k[1], kw, kstep)
    ref = ref_wfr(img, sigma, k[0], k[1], kw, kstep)
    g = wfr_sweep(jnp.asarray(img, jnp.float32), wlist, k, sigma)
    m = 5 * sigma          # the circular-window rim (see ops/wfr.py)
    sl = np.s_[m:-m, m:-m]
    same = np.all(np.asarray(g["w"])[:, m:-m, m:-m]
                  == ref["w"][:, m:-m, m:-m].astype(np.float32), axis=0)
    lock = np.asarray(g["lockin"])[sl]
    scale = np.abs(ref["lockin"][sl]).max()
    err = np.abs(lock - ref["lockin"][sl])[same].max() / scale
    log(f"WFR sweep {n}^2, {len(wlist)} candidates vs ref_wfr:")
    check("winner disagreement fraction", 1.0 - same.mean(), 1e-2,
          "float32 near-ties between adjacent candidates")
    check("max |lockin - ref| / max |ref|", err, 1e-3,
          "float32 zoom DFT over the spectrum window")

    # the pipeline's sweep stage at the headline width (ROADMAP 1.2)
    nm = sz["main"]
    imgm, _, _, ksm = bench.headline_fixtures(nm, r_k=sz["r_k"])
    sig, wls = pipeline_candidate_grids(ksm)
    sweep = jax.jit(lambda x: wfr_sweep_phase_weight_multi(
        x - x.mean(), wls, sig, 2 * sig, chunk=4))
    _, ts = timed(sweep, imgm)
    log(f"  time: 3-peak sweep stage at {nm}^2 (pipeline chunk=4): "
        f"{fmt_ms(ts)}")


def stage_dct(sz):
    """dct2n / idct2n vs scipy.fft.dctn / idctn (float64)."""
    import jax
    import jax.numpy as jnp
    from scipy.fft import dctn, idctn
    from pygpa_tpu.core.fourier import dct2n, idct2n
    n = sz["dct"]
    x = np.random.default_rng(0).standard_normal((n, n))
    f = jax.jit(dct2n)
    fi = jax.jit(idct2n)
    y = np.asarray(f(jnp.asarray(x, jnp.float32)), np.float64)
    ref = dctn(x)
    log(f"DCT-II {n}^2 vs scipy:")
    check("max |dct2n - dctn| / max |dctn|",
          np.abs(y - ref).max() / np.abs(ref).max(), 1e-5,
          "float32 FFT rounding, ~log2(n) * 6e-8")
    back = np.asarray(fi(jnp.asarray(ref, jnp.float32)), np.float64)
    check("max |idct2n - idctn| / max |x|",
          np.abs(back - idctn(ref)).max() / np.abs(x).max(), 1e-5,
          "float32 FFT rounding, ~log2(n) * 6e-8")
    xb = jnp.asarray(np.stack([x, -x]), jnp.float32)
    _, ts = timed(f, xb)
    log(f"  time: dct2n (2, {n}, {n}): {fmt_ms(ts)}")
    _, ts = timed(fi, xb)
    log(f"  time: idct2n (2, {n}, {n}): {fmt_ms(ts)}")


def stage_unwrap(sz):
    """Weighted unwrap vs tests/reference_impls.ref_phase_unwrap (the
    float64 Ghiglia-Romero PCG, converged). Every true neighbour
    difference of the fixture is below pi, so the converged weighted
    solution is the phase itself."""
    import jax
    import jax.numpy as jnp
    from reference_impls import ref_phase_unwrap
    from pygpa_tpu.solvers.unwrap import phase_unwrap, phase_unwrap_mg
    n = sz["unwrap"]
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = n / 2
    psi0 = (0.6 * (xx + yy) / np.sqrt(2)
            + 0.2 * n * np.exp(-((xx - c) ** 2 + (yy - c) ** 2)
                               / (2 * (n / 6) ** 2)))
    psi = (psi0 + np.pi) % (2 * np.pi) - np.pi
    w = 0.3 + 0.7 * np.exp(-((xx - 0.3 * n) ** 2 + (yy - 0.6 * n) ** 2)
                           / (2 * (n / 3) ** 2))
    ref = ref_phase_unwrap(psi, w, kmax=200)
    args = (jnp.asarray(psi, jnp.float32), jnp.asarray(w, jnp.float32))

    def dcfree(a):
        d = (a - a.mean()) - (ref - ref.mean())
        return np.abs(d).max(), np.sqrt((d * d).mean())

    log(f"weighted unwrap {n}^2 vs ref_phase_unwrap (float64, kmax 200):")
    pcg = jax.jit(lambda p, q: phase_unwrap(p, q, kmax=200))
    mx, _ = dcfree(np.asarray(pcg(*args), np.float64))
    check("PCG kmax 200: max |phi - ref| (rad, dc-free)", mx, 1e-3,
          "same algorithm; float32 stops at a 1e-6 relative residual")
    mg = jax.jit(phase_unwrap_mg)
    mx, rms = dcfree(np.asarray(mg(*args), np.float64))
    # the multigrid path is an approximate solver (10 coarse CG
    # iterations + one V-branch round, solvers/unwrap.py); on this
    # fixture its CPU run (float64 and float32 alike) sits at max
    # 0.46-0.60 rad, rms 0.05-0.10 rad from the converged solution
    # for n = 128..1024
    check("multigrid: max |phi - ref| (rad, dc-free)", mx, 0.8,
          "the algorithm's own approximation error, not rounding")
    check("multigrid: rms |phi - ref| (rad, dc-free)", rms, 0.15,
          "the algorithm's own approximation error, not rounding")
    _, ts = timed(pcg, *args)
    log(f"  time: phase_unwrap kmax 200 {n}^2: {fmt_ms(ts)}")
    _, ts = timed(mg, *args)
    log(f"  time: phase_unwrap_mg {n}^2: {fmt_ms(ts)}")


def stage_interp(sz):
    """map_coordinates orders 1 and 3 vs scipy.ndimage."""
    import jax
    import jax.numpy as jnp
    import scipy.ndimage as ndi
    from pygpa_tpu.core import interp
    n = sz["interp"]
    rng = np.random.default_rng(1)
    img = ndi.gaussian_filter(rng.standard_normal((n, n)), 3.0)
    img /= img.std()
    yy, xx = np.meshgrid(np.arange(n, dtype=float),
                         np.arange(n, dtype=float), indexing="ij")
    cy = np.clip(yy + 8 * np.sin(2 * np.pi * xx / n), 0, n - 1)
    cx = np.clip(xx + 8 * np.cos(2 * np.pi * yy / n), 0, n - 1)
    coords = np.stack([cy, cx])
    imj = jnp.asarray(img, jnp.float32)
    cj = jnp.asarray(coords, jnp.float32)
    log(f"map_coordinates {n}^2 vs scipy.ndimage (mode nearest):")
    for order in (1, 3):
        f = jax.jit(lambda a, c, o=order: interp.map_coordinates(
            a, c, order=o, mode="nearest"))
        out = np.asarray(f(imj, cj), np.float64)
        ref = ndi.map_coordinates(img, coords, order=order,
                                  mode="nearest")
        check(f"order {order}: max |out - scipy| (unit-variance image)",
              np.abs(out - ref).max(), 1e-3,
              "float32 coordinates (~n * 6e-8 px) and arithmetic")
        _, ts = timed(f, imj, cj)
        log(f"  time: map_coordinates order {order}: {fmt_ms(ts)}")
    f = jax.jit(lambda a: interp.spline_filter(a, mode="nearest"))
    _, ts = timed(f, imj)
    log(f"  time: spline_filter (FIR prefilter): {fmt_ms(ts)}")


def _numpy_drizzle(img, ks, z):
    """Float64 NumPy drizzle (unit_cell_averaging.py:164-217 semantics:
    every pixel's cell position, bilinear 2x2 overlap, summed)."""
    from pygpa_tpu.ucell.averaging import calc_ucell_parameters
    rmin, rsize = calc_ucell_parameters(ks, z)
    n, m = img.shape
    r = np.stack(np.meshgrid(np.arange(n, dtype=float),
                             np.arange(m, dtype=float), indexing="ij"),
                 -1)
    frac = (r @ ks.T) % 1.0
    R = (frac @ np.linalg.inv(ks).T - rmin) * z
    i0 = np.floor(R).astype(np.int64)
    t = R - i0
    res = np.zeros(rsize[0] * rsize[1])
    wsum = np.zeros(rsize[0] * rsize[1])
    for li in (0, 1):
        for lj in (0, 1):
            wgt = ((t[..., 0] if li else 1 - t[..., 0])
                   * (t[..., 1] if lj else 1 - t[..., 1]))
            a = i0[..., 0] + li
            b = i0[..., 1] + lj
            ok = (a >= 0) & (a < rsize[0]) & (b >= 0) & (b < rsize[1])
            flat = (a * rsize[1] + b)[ok]
            res += np.bincount(flat, (img * wgt)[ok], res.size)
            wsum += np.bincount(flat, wgt[ok], res.size)
    return res.reshape(rsize), wsum.reshape(rsize), rmin


def stage_ucell(sz):
    """unit_cell_average + expand_unitcell vs a NumPy drizzle and
    scipy.ndimage.map_coordinates."""
    import jax
    import jax.numpy as jnp
    import scipy.ndimage as ndi
    from pygpa_tpu.ucell import unit_cell_average, expand_unitcell
    n = sz["ucell"]
    img, _, _, ks = bench.headline_fixtures(n, r_k=sz["r_k"])
    ks2 = ks[:2]
    z = 2
    avg = jax.jit(lambda a: unit_cell_average(a, ks2, z=z,
                                              return_weights=True))
    cell, wsum = (np.asarray(a, np.float64) for a in avg(img))
    res_ref, w_ref, rmin = _numpy_drizzle(np.asarray(img, np.float64),
                                          ks2, z)
    log(f"unit-cell average {n}^2 -> {cell.shape} vs NumPy drizzle:")
    # float32 cell positions: (r . k) mod 1 with |r . k| up to ~n * r_k
    # keeps ~ulp(n * r_k) of the fraction, ~2e-3 px of the zoomed cell
    # at 4096^2, which moves bilinear weight between neighbouring bins
    # (measured 1.49e-3 relative on the CPU and the GPU alike); the
    # atomic scatter-add's run-dependent summation order adds ~1e-6
    why = "float32 cell positions (~2e-3 px at 4096^2) and atomics"
    check("max |wsum - ref| / max ref",
          np.abs(wsum - w_ref).max() / w_ref.max(), 5e-3, why)
    ok = w_ref > 1e-3 * w_ref.max()
    cell_ref = res_ref[ok] / w_ref[ok]
    check("max |cell - ref| / max |ref|",
          np.abs(cell[ok] - cell_ref).max() / np.abs(cell_ref).max(), 1e-3,
          why)
    exp = jax.jit(lambda c: expand_unitcell(c, ks2, (n, n), z=z))
    rec = np.asarray(exp(jnp.asarray(cell, jnp.float32)), np.float64)
    r = np.stack(np.meshgrid(np.arange(n, dtype=float),
                             np.arange(n, dtype=float), indexing="ij"), -1)
    X = ((r @ ks2.T) % 1.0) @ np.linalg.inv(ks2).T
    X = (X - rmin) * z
    rec_ref = ndi.map_coordinates(np.nan_to_num(cell), np.moveaxis(X, -1, 0),
                                  order=3, mode="constant", cval=0.0)
    # a pixel whose float32 (r . k) mod 1 rounds to the other side of
    # a cell seam than in float64 samples the opposite cell edge: a
    # handful of seam pixels differ by O(signal), the rest by rounding
    err = np.abs(rec - rec_ref) / np.abs(rec_ref).max()
    check("expand: share of pixels off by > 1e-3 of max |scipy|",
          float((err > 1e-3).mean()), 1e-3,
          "float32 seam rounding of the cell coordinate")
    check("expand: 99.9th percentile |rec - scipy| / max |scipy|",
          float(np.percentile(err, 99.9)), 1e-3,
          "float32 cell coordinates and B-spline arithmetic")
    _, ts = timed(avg, img)
    log(f"  time: unit_cell_average {n}^2: {fmt_ms(ts)}")
    cj = jnp.asarray(cell, jnp.float32)
    _, ts = timed(exp, cj)
    log(f"  time: expand_unitcell {n}^2: {fmt_ms(ts)}")


# --- phase 4 -------------------------------------------------------------

def _spans(arr, devs, name):
    got = arr.sharding.device_set
    log(f"  {name}: output on {len(got)} devices")
    if got != set(devs):
        raise AssertionError(f"{name} is on {got}, not on {devs}")


def phase_four(sz, devs):
    import jax
    import jax.numpy as jnp
    from pygpa_tpu import gpa
    from pygpa_tpu.parallel import (make_mesh, wfr_sweep_sharded,
                                    extract_displacement_field_batch,
                                    extract_displacement_field_sharded)
    from pygpa_tpu.ops.wfr import wfr_sweep
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    mesh = make_mesh(len(devs), ("batch",))
    one = devs[0]
    n = sz["four"]

    # batch mesh: 4 frames, each an exactly translated lattice
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    ks = np.asarray(generate_ks(sz["r_k"], bench.THETA, kappa=bench.KAPPA,
                                psi=bench.PSI))[:3]
    frames = np.stack([np.asarray(hexlattice_gen(
        sz["r_k"], bench.THETA, order=2, size=n, kappa=bench.KAPPA,
        psi=bench.PSI, shift=np.full((2, n, n), 0.31 * i, np.float32),
        dtype=jnp.float32)) for i in range(len(devs))])
    t0 = time.perf_counter()
    us = extract_displacement_field_batch(frames, ks, mesh=mesh)
    us.block_until_ready()
    log(f"batch pipeline {len(devs)} x {n}^2: first call "
        f"{time.perf_counter() - t0:.2f} s")
    _spans(us, devs, "extract_displacement_field_batch")
    worst = 0.0
    for i in range(len(devs)):
        ref = gpa.extract_displacement_field(
            jax.device_put(frames[i], one), ks)
        worst = max(worst, float(np.abs(np.asarray(us[i])
                                        - np.asarray(ref)).max()))
    check("batch vs one-device, max |du| (px)", worst, 1e-3,
          "same program per frame; float32 reduction order")

    # candidate-sharded sweep (full-FFT chunked sweep on each device)
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    sigma = int(np.ceil(1 / knorms.min()))
    wlist = _wgrid(ks[0][0], ks[0][1], kw, kw / 3)
    img0 = jnp.asarray(frames[0] - frames[0].mean())
    g = wfr_sweep_sharded(img0, wlist, ks[0], sigma, mesh=mesh,
                          with_grad=True)
    g["lockin"].block_until_ready()
    _spans(g["lockin"], devs, "wfr_sweep_sharded")
    r = wfr_sweep(jax.device_put(img0, one), wlist, ks[0], sigma,
                  with_grad=True, zoom=False)
    scale = float(jnp.abs(r["lockin"]).max())
    log(f"candidate-sharded sweep {n}^2, {len(wlist)} candidates:")
    check("max |lockin - one-device| / max |lockin|",
          float(np.abs(np.asarray(g["lockin"])
                       - np.asarray(r["lockin"])).max()) / scale, 1e-3,
          "same chunked sweep; the plane-wave rebase phase 2 pi k.r "
          "(up to ~1e3 rad) is rounded by another float32 expression")

    # one image row-sharded end to end vs the one-device extractor
    nb = sz["four_big"]
    img, _, _, ks = bench.headline_fixtures(nb, r_k=sz["r_k"])
    t0 = time.perf_counter()
    u_sh = extract_displacement_field_sharded(img, ks, mesh,
                                              unwrap_coarse=4)
    u_sh.block_until_ready()
    log(f"row-sharded pipeline {nb}^2: first call "
        f"{time.perf_counter() - t0:.2f} s")
    _spans(u_sh, devs, "extract_displacement_field_sharded")
    fn = make_displacement_extractor((nb, nb), ks, unwrap_coarse=4)
    u1 = np.asarray(fn(jax.device_put(img, one)))
    b = 8 * sigma
    d = np.abs(np.asarray(u_sh) - u1)[:, b:-b, b:-b]
    check("row-sharded vs one-device, max |du| interior (px)",
          float(d.max()), 1e-3,
          "same math; pencil transforms and partitioned matmuls sum "
          "in another order")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device parallel/ paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on whatever platform is present")
    args = ap.parse_args(argv)
    sz = REHEARSE if args.rehearse else FULL
    n_dev = 4 if args.four else 1
    devs = phase_device(args.rehearse, n_dev)
    if args.four:
        phase_four(sz, devs)
    else:
        phase_main_path(sz)
        for stage in (stage_sweep, stage_dct, stage_unwrap, stage_interp,
                      stage_ucell):
            stage(sz)
    print(json.dumps({"ok": True, "device": bench.device_record(devs)}),
          flush=True)


if __name__ == "__main__":
    bench.use_repo_compile_cache()
    main()
