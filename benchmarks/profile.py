"""Per-stage device times of the 4096^2 headline pipeline, on one GPU.

Emits ONE JSON object with a decomposition of the bench.py pipeline
into independently-timed stages: each stage is its own jitted program
re-running the production code path on production-shaped inputs, timed
as the median and interquartile range of OUTER calls that each end in
block_until_ready (after one warm call). Needs a GPU; prints the card's
name and power limit.

    python benchmarks/profile.py [--out PROFILE.json] [--size N]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def time_stage(fn, *args, outer=5):
    """(median_ms, iqr_ms, raw_ms) of `outer` calls after a warm one."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(outer):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.asarray(ts)
    return (float(np.median(ts)),
            float(np.percentile(ts, 75) - np.percentile(ts, 25)),
            [float(t) for t in ts])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the JSON to this path")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--outer", type=int, default=5)
    args = ap.parse_args()
    bench.use_repo_compile_cache()
    devs = bench.require_gpu()
    card = bench.card_name_and_power()
    print(card, flush=True)

    import jax
    import jax.numpy as jnp
    from pygpa_tpu.config import DEFAULTS
    from pygpa_tpu.gpa.pipeline import (make_displacement_extractor,
                                        gaussian_deconvolve,
                                        pipeline_candidate_grids)
    from pygpa_tpu.ops.wfr import wfr_sweep_phase_weight_multi
    from pygpa_tpu.gpa.reconstruct import reconstruct_u_inv_from_demod

    size = args.size
    img, _, _, ks = bench.headline_fixtures(size)
    sig, wlists = pipeline_candidate_grids(ks)
    dr = 2 * sig
    img0 = img - img.mean()
    kv = jnp.asarray(ks, jnp.float32)

    stages = {}

    def record(name, fn, *a):
        med, iqr, raw = time_stage(jax.jit(fn), *a, outer=args.outer)
        stages[name] = {"ms": med, "iqr_ms": iqr, "raw_ms": raw}
        print(f"  {name}: {med:.3f} ms (iqr {iqr:.3f})", flush=True)

    extract = make_displacement_extractor((size, size), ks, chunk=4,
                                          unwrap_coarse=4)
    record("full_pipeline", extract, img)
    record("sweep_pw_3peaks",
           lambda x: wfr_sweep_phase_weight_multi(x, wlists, sig, dr,
                                                  chunk=4), img0)
    record("sweep_grad_3peaks",
           lambda x: wfr_sweep_phase_weight_multi(
               x, wlists, sig, dr, chunk=4, with_grad=True, krefs=ks),
           img0)
    ph, wt = jax.jit(lambda x: wfr_sweep_phase_weight_multi(
        x, wlists, sig, dr, chunk=4))(img0)
    record("reconstruct_mg",
           lambda p, w: reconstruct_u_inv_from_demod(
               kv, p, w, kmax=DEFAULTS.unwrap_kmax_reconstruct,
               unwrap_coarse=4), ph, wt)
    u2 = jnp.zeros((2, size, size), jnp.float32)
    record("deconvolve_2comp", lambda u: gaussian_deconvolve(u, sig, dr),
           u2)

    out = {"config": {"size": size, "sigma": sig,
                      "P": int(wlists[0].shape[0]), "G": len(wlists),
                      "outer_reps": args.outer},
           "device": bench.device_record(devs), "card": card,
           "stages": stages}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
