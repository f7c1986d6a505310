"""Multi-device sharding logic on the virtual 8-device CPU mesh:
the sharded WFR sweep and the batch-sharded pipeline must equal their
single-device counterparts."""
import numpy as np
import jax
import jax.numpy as jnp

from pygpa_tpu.lattices import hexlattice_gen, generate_ks
from pygpa_tpu.ops.wfr import wfr_sweep
from pygpa_tpu.parallel import (make_mesh, wfr_sweep_sharded,
                                extract_displacement_field_batch)
from pygpa_tpu import gpa


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def _small():
    r_k = 0.12
    img = np.array(hexlattice_gen(r_k, 9.0, order=1, size=96,
                                  dtype=np.float64))
    ks = np.array(generate_ks(r_k, 9.0))[:3]
    return img - img.mean(), ks


def test_sharded_wfr_matches_single():
    img, ks = _small()
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    wxs = np.arange(k[0] - kw, k[0] + kw, kstep)
    wys = np.arange(k[1] - kw, k[1] + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    wlist = np.stack([wx.ravel(), wy.ravel()], -1)
    sigma = 8
    mesh = make_mesh(8, ("batch",))
    single = wfr_sweep(jnp.asarray(img), wlist, k, sigma, with_grad=True)
    shard = wfr_sweep_sharded(jnp.asarray(img), wlist, k, sigma,
                              mesh=mesh, with_grad=True)
    assert np.allclose(np.array(shard["lockin"]),
                       np.array(single["lockin"]), atol=1e-10)
    assert np.allclose(np.array(shard["w"]), np.array(single["w"]))
    assert np.allclose(np.array(shard["grad"]),
                       np.array(single["grad"]), atol=1e-10)


def test_batch_sharded_pipeline():
    img, ks = _small()
    batch = np.stack([img, np.roll(img, 5, axis=0),
                      np.roll(img, -3, axis=1), img[::-1],
                      img, np.roll(img, 2, axis=0),
                      np.roll(img, 1, axis=1), img])
    mesh = make_mesh(8, ("batch",))
    us = np.array(extract_displacement_field_batch(batch, ks, mesh=mesh))
    assert us.shape == (8, 2) + img.shape
    u_single = np.array(gpa.extract_displacement_field(batch[1], ks))
    assert np.allclose(us[1], u_single, atol=1e-8)


def test_pencil_fft_matches_single():
    """Distributed pencil FFT (all_to_all re-sharding) == fft2."""
    from pygpa_tpu.parallel import fft2_sharded, ifft2_sharded
    rng = np.random.default_rng(0)
    img = rng.normal(size=(128, 256))
    mesh = make_mesh(8, ("batch",))
    ref = np.fft.fft2(img)
    out = np.asarray(fft2_sharded(jnp.asarray(img), mesh))
    assert np.allclose(out, ref, atol=1e-9)
    back = np.asarray(ifft2_sharded(jnp.asarray(out), mesh)).real
    assert np.allclose(back, img, atol=1e-9)


def test_spatial_sweep_matches_single():
    """Row-sharded zoom sweep of one image == the single-device zoom
    sweep (demodulated lock-in + absq), SURVEY.md:346-348 contract."""
    from pygpa_tpu.parallel import wfr_sweep_spatial
    img, ks = _small()
    # 96 rows are not divisible by 8 after windowing needs; use 128
    r_k = 0.12
    img = np.array(hexlattice_gen(r_k, 9.0, order=1, size=128,
                                  dtype=np.float64))
    img = img - img.mean()
    ks = np.array(generate_ks(r_k, 9.0))[:3]
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    wxs = np.arange(k[0] - kw, k[0] + kw, kstep)
    wys = np.arange(k[1] - kw, k[1] + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    wlist = np.stack([wx.ravel(), wy.ravel()], -1)
    sigma = 8
    mesh = make_mesh(8, ("batch",))
    single = wfr_sweep(jnp.asarray(img), wlist, k, sigma,
                       rebase=False, return_absq=True, with_w=False)
    shard = wfr_sweep_spatial(jnp.asarray(img), wlist, k, sigma,
                              mesh=mesh)
    assert np.allclose(np.asarray(shard["absq"]),
                       np.asarray(single["absq"]), rtol=1e-6,
                       atol=1e-12)
    assert np.allclose(np.asarray(shard["lockin"]),
                       np.asarray(single["lockin"]), atol=1e-8)


def test_2d_mesh_batch_by_candidate():
    """Batch x candidate sharding composed on ONE 2D mesh (4 batch x 2
    candidate): per-image sweeps run under vmap with the candidate
    grid sharded on the inner axis; equals the single-device result."""
    img, ks = _small()
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    wxs = np.arange(k[0] - kw, k[0] + kw, kstep)
    wys = np.arange(k[1] - kw, k[1] + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    wlist = np.stack([wx.ravel(), wy.ravel()], -1)
    sigma = 8
    mesh = make_mesh(8, ("batch", "k"), shape=(4, 2))
    batch = np.stack([img, img[::-1], img[:, ::-1], img[::-1, ::-1]])

    refs = [wfr_sweep(jnp.asarray(b), wlist, k, sigma) for b in batch]

    outs = [wfr_sweep_sharded(jnp.asarray(b), wlist, k, sigma,
                              mesh=mesh, axis="k") for b in batch]
    for ref, out in zip(refs, outs):
        assert np.allclose(np.asarray(out["lockin"]),
                           np.asarray(ref["lockin"]), atol=1e-9)
    # and the batch axis of the same mesh drives the data-parallel
    # pipeline at the same time
    us = extract_displacement_field_batch(batch, ks, mesh=mesh)
    u0 = gpa.extract_displacement_field(batch[0], ks)
    assert np.allclose(np.asarray(us[0]), np.asarray(u0), atol=1e-9)


def test_sharded_sweep_tie_break():
    """Identical candidates on different devices: the LOWEST global
    candidate index must win everywhere (the reference's sequential
    first-max semantics; strict '>' never replaces an equal)."""
    img, ks = _small()
    k = ks[0]
    sigma = 8
    wlist = np.tile(k[None, :], (16, 1))   # 16 identical candidates
    mesh = make_mesh(8, ("batch",))
    out = wfr_sweep_sharded(jnp.asarray(img), wlist, k, sigma,
                            mesh=mesh)
    # every pixel's winning w equals candidate 0's w; and the winner
    # index embedded in the w-field lookup is the first one
    single = wfr_sweep(jnp.asarray(img), wlist, k, sigma)
    assert np.allclose(np.asarray(out["lockin"]),
                       np.asarray(single["lockin"]), atol=1e-9)
    assert np.allclose(np.asarray(out["w"]),
                       np.asarray(single["w"]))


def test_sharded_dct_matches_single():
    """Pencil all_to_all DCT == the single-device dct2n/idct2n."""
    from pygpa_tpu.parallel import dct2n_sharded, idct2n_sharded
    from pygpa_tpu.core.fourier import dct2n, idct2n
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 128))
    mesh = make_mesh(8, ("batch",))
    ref = np.asarray(dct2n(jnp.asarray(x)))
    out = np.asarray(dct2n_sharded(jnp.asarray(x), mesh))
    assert np.allclose(out, ref, atol=1e-8)
    back = np.asarray(idct2n_sharded(jnp.asarray(out), mesh))
    assert np.allclose(back, x, atol=1e-9)


def test_sharded_unwrap_matches_single():
    """Distributed-preconditioner CG unwrap == the single-device
    solver (same algorithm, DCTs via the pencil pattern)."""
    from pygpa_tpu.parallel import phase_unwrap_prediff_sharded
    from pygpa_tpu.solvers.unwrap import phase_unwrap_prediff
    rng = np.random.default_rng(2)
    n = m = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    phi_true = 0.08 * xx + 0.03 * yy + 2.0 * np.sin(xx / 9.0)
    psi = (phi_true + np.pi) % (2 * np.pi) - np.pi
    w = jnp.asarray(0.5 + rng.uniform(size=(n, m)))
    dx = jnp.asarray(np.diff(psi, axis=-1))
    dy = jnp.asarray(np.diff(psi, axis=-2))
    mesh = make_mesh(8, ("batch",))
    ref = np.asarray(phase_unwrap_prediff(dx, dy, w, kmax=30))
    out = np.asarray(phase_unwrap_prediff_sharded(dx, dy, w, mesh,
                                                  kmax=30))
    assert np.allclose(out, ref, atol=1e-6)


def test_sharded_pipeline_end_to_end():
    """extract_displacement_field_sharded == the single-device demod
    pipeline on a row-sharded image (the larger-than-one-device
    single-image path runs sweep -> lstsq -> unwrap sharded)."""
    from pygpa_tpu.parallel import extract_displacement_field_sharded
    from pygpa_tpu.gpa.pipeline import make_displacement_extractor
    r_k = 0.12
    size = 128
    img = np.array(hexlattice_gen(r_k, 9.0, order=1, size=size,
                                  dtype=np.float64))
    ks = np.array(generate_ks(r_k, 9.0))[:3]
    mesh = make_mesh(8, ("batch",))
    u_sh = np.asarray(extract_displacement_field_sharded(
        jnp.asarray(img), ks, mesh, unwrap_coarse=4))
    fn = make_displacement_extractor((size, size), ks,
                                     unwrap_coarse=4,
                                     dtype=jnp.float64)
    u_ref = np.asarray(fn(jnp.asarray(img)))
    assert u_sh.shape == u_ref.shape
    # same math, different reduction orders (pencil transforms,
    # partitioned matmuls)
    assert np.allclose(u_sh, u_ref, atol=1e-6)


def test_spatial_sweep_dots_keep_their_precision():
    """Every dot of the row-sharded zoom sweep still carries HIGHEST
    after shard_map partitioning (a DotAlgorithmPreset is dropped there
    and the GPU then runs the dots in TF32)."""
    from pygpa_tpu.parallel import wfr_sweep_spatial
    r_k = 0.12
    img = np.array(hexlattice_gen(r_k, 9.0, order=1, size=128,
                                  dtype=np.float32))
    img = jnp.asarray(img - img.mean())
    ks = np.array(generate_ks(r_k, 9.0))[:3]
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    wxs = np.arange(k[0] - kw, k[0] + kw, kw / 3)
    wx, wy = np.meshgrid(wxs, np.arange(k[1] - kw, k[1] + kw, kw / 3),
                         indexing="ij")
    wlist = np.stack([wx.ravel(), wy.ravel()], -1)
    mesh = make_mesh(4, ("batch",))
    spec = jnp.fft.fft2(img)
    txt = jax.jit(lambda s: wfr_sweep_spatial(
        img, wlist, k, 8, mesh, spectrum=s)["absq"]).lower(
            spec).compile().as_text()
    dots = [ln for ln in txt.splitlines() if " dot(" in ln]
    assert len(dots) >= 4
    assert all("operand_precision={highest,highest}" in ln for ln in dots)
