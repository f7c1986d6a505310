"""Benchmark: full-pipeline GPA throughput on a 4096^2 moire image.

Metric (BASELINE.json): Mpix/s for FFT -> WFR sweep (3 Bragg peaks x
36 candidates) -> weighted lstsq -> multigrid unwrap -> displacement
field, float32, one GPU. Reference (pyGPA, single CPU core) is
estimated at 0.05-0.2 Mpix/s (BASELINE.md); vs_baseline uses the
favorable-to-reference 0.2.

Needs a GPU: it exits non-zero when JAX finds none. Prints the card's
name and power limit, then ONE JSON line.

    python bench.py

The helpers below (compile cache, GPU check, the headline fixtures and
their accuracy gates) are shared with chip_smoke.py and benchmarks/.
"""
import json
import os
import subprocess
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the headline fixture: a rendered moire lattice (r_k, theta, kappa,
# psi); benchmarks/run_all.py config 6 uses it at 8192^2
R_K, THETA, KAPPA, PSI = 0.02, 5.0, 1.005, 10.0

# HARD accuracy gates of the 4096^2 headline (px); a speed change that
# trades past these fails the bench outright
GATES = {"u_err_interior_px": 0.002,
         "u_err_interior_dcfree_px": 0.0012,
         "u_err_deformed_px": 0.075}


def use_repo_compile_cache():
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says (JAX reads that variable itself), else in .jax_cache/ at the
    repo root. Call before the first compilation."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(REPO, ".jax_cache"))


def require_gpu():
    """Return jax.devices() if they are GPUs; otherwise exit non-zero:
    a measurement never falls back to another platform."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU found (JAX platform is "
                         f"{devs[0].platform!r}); nothing measured")
    return devs


def card_name_and_power():
    """`nvidia-smi --query-gpu=name,power.limit` as one line per card.
    nvidia-smi does not touch JAX, so it can run beside this process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record(devs):
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def headline_fixtures(size, r_k=R_K):
    """(image, deformed image, analytic u of the deformed one, ks): the
    zero-displacement lattice and the Gaussian-envelope x-shift of the
    conftest 500^2 fixture scaled to `size` (a KNOWN analytic u, so the
    pipeline error on a nonzero displacement is gated too)."""
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    img = hexlattice_gen(r_k, THETA, order=2, size=size, kappa=KAPPA,
                         psi=PSI, dtype=jnp.float32)
    ks = np.asarray(generate_ks(r_k, THETA, kappa=KAPPA, psi=PSI))[:3]
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S),
                         indexing="ij")
    xshift = (0.1 * xp
              * np.exp(-0.5 * ((xp / (2 * S / 8)) ** 2
                               + 1.2 * (yp / (2 * S / 6)) ** 2)))
    u_true = np.stack((xshift, np.zeros_like(xshift))).astype(np.float32)
    img_d = hexlattice_gen(r_k, THETA, order=2, size=size, kappa=KAPPA,
                           psi=PSI, shift=u_true, dtype=jnp.float32)
    return img, img_d, u_true, ks


def interior_errors(u, ks):
    """Raw and dc-free max |u| over the 8-sigma-trimmed interior of a
    field recovered from the ZERO-displacement fixture (its ks match
    the rendered lattice exactly, so |u| IS the pipeline error). GPA
    determines u only up to a constant, so the dc-free number is the
    physically meaningful ripple; the raw one bounds the unwrap DC."""
    import jax.numpy as jnp
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[:, b:-b, b:-b]
    um = ui - ui.mean(axis=(1, 2), keepdims=True)
    return (float(jnp.max(jnp.abs(ui))), float(jnp.max(jnp.abs(um))))


def deformed_error(u_d, u_true, ks):
    """Recovered -u vs the analytic truth, mean-subtracted, after the
    reference's deconvolve=True Wiener step (the raw field carries the
    sigma-wide lock-in window blur)."""
    import jax.numpy as jnp
    from pygpa_tpu.gpa.pipeline import gaussian_deconvolve
    sig = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    b = 8 * sig
    ud = gaussian_deconvolve(u_d, sig, 2 * sig)
    resid = (-ud - jnp.asarray(u_true))[:, b:-b, b:-b]
    resid = resid - resid.mean(axis=(1, 2), keepdims=True)
    return float(jnp.max(jnp.abs(resid)))


def headline_gate_values(fn, img, img_d, u_true, ks):
    raw, dcfree = interior_errors(fn(img), ks)
    return {"u_err_interior_px": raw,
            "u_err_interior_dcfree_px": dcfree,
            "u_err_deformed_px": deformed_error(fn(img_d), u_true, ks)}


def failed_gates(values, gates):
    return {k: (v, gates[k]) for k, v in values.items()
            if not v < gates[k]}


def main():
    use_repo_compile_cache()
    devs = require_gpu()
    card = card_name_and_power()
    print(card, flush=True)
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor

    size = 4096
    img, img_d, u_true, ks = headline_fixtures(size)
    fn = make_displacement_extractor((size, size), ks, chunk=4,
                                     unwrap_coarse=4)
    t0 = time.perf_counter()
    fn(img).block_until_ready()
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(img).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    mpix_s = size * size / 1e6 / dt

    values = headline_gate_values(fn, img, img_d, u_true, ks)
    bad = failed_gates(values, GATES)
    rec = {"metric": "full-pipeline GPA throughput (4096^2 moire, "
                     "FFT+WFR sweep+lstsq+multigrid unwrap, f32)",
           "value": mpix_s, "unit": "Mpix/s",
           "vs_baseline": mpix_s / 0.2,
           "seconds_per_image": times,
           "first_call_s": compile_s,
           **values,
           "gates": GATES,
           "device": device_record(devs), "card": card}
    if bad:
        rec.update(metric="ACCURACY GATE FAILED", value=0.0,
                   vs_baseline=0.0, failed_gates=bad)
    print(json.dumps(rec))
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
