"""End-to-end pipeline tests against analytic ground truth, mirroring
the reference's tolerances
(/root/reference/tests/test_geometric_phase_analysis.py:61-78).
"""
import numpy as np
import jax.numpy as jnp

from pygpa_tpu import gpa


def test_displacement_field(testset_gaussian, gaussiandeform):
    original, deformed, noise, ori_ks = testset_gaussian
    u = -np.array(gpa.extract_displacement_field(deformed + noise,
                                                 ori_ks[:3]))
    assert u.shape == gaussiandeform.shape
    err = np.abs(u - gaussiandeform)[:, 20:-20, 20:-20]
    print("noisy max err:", err.max())
    assert np.all(err < 0.9)

    u2 = -np.array(gpa.extract_displacement_field(deformed, ori_ks[:3],
                                                  deconvolve=True))
    assert u2.shape == gaussiandeform.shape
    err2 = np.abs(u2 - gaussiandeform)[:, 20:-20, 20:-20]
    print("deconvolved max err:", err2.max())
    assert np.all(err2 < 0.05)


def test_reconstruction(testset_gaussian, gaussiandeform):
    original, deformed, noise, ori_ks = testset_gaussian
    u_inv = np.array(gpa.invert_u_overlap(jnp.asarray(-gaussiandeform)))
    assert u_inv.shape == gaussiandeform.shape
    reconstructed = np.array(gpa.undistort_image(deformed, gaussiandeform))
    err = np.abs(reconstructed - original) / np.abs(original).max()
    print("reconstruction max rel err:", err.max())
    # reference tolerance on the full interior; the outermost pixel ring
    # differs slightly (Catmull-Rom clamp vs scipy's spline boundary)
    assert np.all(err[1:-1, 1:-1] < 0.02)
    assert np.all(err < 0.03)


def test_iterate_gpa(testset_gaussian):
    """iterate_GPA refines deliberately-offset k-vectors back toward
    the truth (the reference has no direct test; this checks the
    contract of geometric_phase_analysis.py:116-154)."""
    original, deformed, noise, ori_ks = testset_gaussian
    ks = ori_ks[:3]
    offset = np.array([0.002, -0.001])
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    prs, w, corr = gpa.iterate_GPA(jnp.asarray(original),
                                   ks + offset, sigma)
    corr = np.array(corr)
    # the correction should cancel most of the imposed offset
    assert np.all(np.linalg.norm(corr + offset, axis=1)
                  < 0.35 * np.linalg.norm(offset))


def test_reconstruct_u_inv_consistency(testset_gaussian, gaussiandeform):
    """reconstruct_u_inv (unwrapped-phase path) agrees with the
    gradient-integration path on clean data."""
    original, deformed, noise, ori_ks = testset_gaussian
    ks = ori_ks[:3]
    u, gs = gpa.extract_displacement_field(deformed, ks, return_gs=True)
    phases = jnp.stack([jnp.angle(g["lockin"]) for g in gs])
    weights = jnp.stack([jnp.abs(g["lockin"]) for g in gs])
    # unwrapped phases from the analytic truth: -2 pi K u_d
    true_phases = -2 * np.pi * np.einsum(
        "kc,cnm->knm", ks, gaussiandeform)
    us = np.array(gpa.reconstruct_u_inv(ks, jnp.asarray(true_phases),
                                        weights))
    center = np.s_[:, 100:-100, 100:-100]
    resid = (us - (-gaussiandeform))[center]
    assert np.abs(resid - resid.mean(axis=(1, 2), keepdims=True)).max() \
        < 1e-6


def test_factory_matches_eager(testset_gaussian):
    """make_displacement_extractor (demod fast path, one executable)
    equals extract_displacement_field (rebased path) exactly."""
    import numpy as np
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    original, deformed, noise, ori_ks = testset_gaussian
    ks = ori_ks[:3]
    fn = make_displacement_extractor(deformed.shape, ks,
                                     dtype=np.float64)
    u_fact = np.array(fn(deformed))
    u_eager = np.array(gpa.extract_displacement_field(deformed, ks))
    assert np.allclose(u_fact, u_eager, atol=1e-9)


def test_reconstruction_coarse_inversion(testset_gaussian,
                                         gaussiandeform):
    """The coarse-grid displacement inversion (coarse > 1) must meet
    the same reference tolerance as the exact path."""
    import numpy as np
    original, deformed, noise, ori_ks = testset_gaussian
    rec = np.array(gpa.undistort_image(deformed, gaussiandeform,
                                       coarse=4))
    err = np.abs(rec - original) / np.abs(original).max()
    print("coarse=4 reconstruction max rel err:", err.max())
    assert np.all(err[1:-1, 1:-1] < 0.02)


def test_factory_multigrid_accuracy(testset_gaussian, gaussiandeform):
    """The multigrid-unwrap production path (unwrap_coarse) must meet
    the same reference displacement tolerances as the exact path."""
    import numpy as np
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    original, deformed, noise, ori_ks = testset_gaussian
    ks = ori_ks[:3]
    fn = make_displacement_extractor(deformed.shape, ks,
                                     dtype=np.float64, unwrap_coarse=4)
    u = -np.array(fn(deformed + noise))
    assert np.all(np.abs(u - gaussiandeform)[:, 20:-20, 20:-20] < 0.9)
    fn2 = make_displacement_extractor(deformed.shape, ks,
                                      dtype=np.float64, unwrap_coarse=4,
                                      deconvolve=True)
    u2 = -np.array(fn2(deformed))
    assert np.all(np.abs(u2 - gaussiandeform)[:, 20:-20, 20:-20] < 0.05)


def test_wfr_sweep_phase_weight_fallback_parity():
    """wfr_sweep_phase_weight (pipeline hot-path entry) must equal the
    manual angle/sqrt/mask composition on the XLA fallback path."""
    import jax.numpy as jnp
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.ops.wfr import wfr_sweep, wfr_sweep_phase_weight
    img = np.asarray(hexlattice_gen(0.1, 7.0, order=1, size=128,
                                    dtype=np.float64))
    img = img - img.mean()
    ks = np.asarray(generate_ks(0.1, 7.0))[:3]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    wxs = np.arange(ks[0, 0] - kw, ks[0, 0] + kw, kw / 3)
    wys = np.arange(ks[0, 1] - kw, ks[0, 1] + kw, kw / 3)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    wlist = np.stack([wx.ravel(), wy.ravel()], -1)
    dr = 20
    ph, w = wfr_sweep_phase_weight(jnp.asarray(img), wlist, ks[0], 10,
                                   dr)
    g = wfr_sweep(jnp.asarray(img), wlist, ks[0], 10, with_w=False,
                  rebase=False, return_absq=True)
    mask = np.zeros(img.shape)
    mask[dr:-dr, dr:-dr] = 1.0
    assert np.allclose(np.asarray(ph), np.angle(np.asarray(g["lockin"])),
                       atol=1e-12)
    assert np.allclose(np.asarray(w),
                       np.sqrt(np.asarray(g["absq"])) * (mask + 1e-6),
                       rtol=1e-12)


def test_invert_u_dual_warp_matches_per_component():
    """The single-launch dual-component warp inside invert_u (order 1,
    'nearest') equals per-component map_coordinates exactly."""
    import jax.numpy as jnp
    from pygpa_tpu.gpa.pipeline import invert_u
    from pygpa_tpu.core import interp
    rng = np.random.default_rng(5)
    n, m = 96, 112
    yy, xx = np.meshgrid(np.arange(n, dtype=float),
                         np.arange(m, dtype=float), indexing="ij")
    us = np.stack([2.0 * np.sin(yy / 17) * np.cos(xx / 13),
                   1.5 * np.cos(yy / 11)])
    fast = invert_u(jnp.asarray(us), iters=7, order=1)

    # plain reference loop
    u_it = np.zeros_like(us)
    xxj, yyj = jnp.mgrid[:n, :m]
    cur = None
    for _ in range(8):  # body applied once for init + 7 loop iters
        coords = jnp.stack([xxj + (0 if cur is None else cur[0]),
                            yyj + (0 if cur is None else cur[1])])
        cur = jnp.stack([
            interp.map_coordinates(jnp.asarray(us[0]), coords, order=1,
                                   mode="nearest"),
            interp.map_coordinates(jnp.asarray(us[1]), coords, order=1,
                                   mode="nearest")])
    assert np.allclose(np.asarray(fast), np.asarray(cur), atol=1e-12)


def test_pipeline_candidate_grids_fixed_count():
    """The production candidate grids have exactly (2*ksteps)^2 points
    per Bragg peak even where np.arange's rounded endpoint spills an
    extra sample (the 4096^2 bench fixture's first peak: 6 x 7), so the
    single-device and the sharded pipelines sweep the same candidates."""
    from pygpa_tpu.gpa.api import _wgrid
    from pygpa_tpu.gpa.pipeline import pipeline_candidate_grids
    from pygpa_tpu.lattices import generate_ks
    ks = np.asarray(generate_ks(0.02, 5.0, kappa=1.005, psi=10.0))[:3]
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    assert any(len(_wgrid(k[0], k[1], kw, kw / 3)) != 36 for k in ks)
    sig, wlists = pipeline_candidate_grids(ks)
    assert sig == int(np.ceil(1 / knorms.min()))
    for k, w in zip(ks, wlists):
        assert w.shape == (36, 2)
        np.testing.assert_allclose(w.mean(axis=0), k - kw / 6, atol=1e-15)
        np.testing.assert_allclose(w[0], k - kw, atol=1e-15)
