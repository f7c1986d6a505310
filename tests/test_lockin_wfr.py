"""Lock-in and WFR sweep: single-FFT formulations vs the literal NumPy oracle
(the reference repo's variant-equivalence strategy,
/root/reference/tests/test_geometric_phase_analysis.py:82-97)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pygpa_tpu.ops.lockin import gpa_lockin, gpa_lockin_batch
from pygpa_tpu.ops.wfr import wfr_sweep
from pygpa_tpu import gpa
from reference_impls import ref_lockin, ref_wfr


@pytest.fixture(scope="module")
def small_lattice():
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    r_k = 0.15
    img = np.array(hexlattice_gen(r_k, 13.0, order=1, size=192,
                                  dtype=np.float64))
    ks = np.array(generate_ks(r_k, 13.0))[:3]
    return img - img.mean(), ks


def test_lockin_matches_oracle(small_lattice):
    img, ks = small_lattice
    for k in ks:
        mine = np.asarray(gpa_lockin(jnp.asarray(img), jnp.asarray(k),
                                     sigma=10))
        ref = ref_lockin(img, k[0], k[1], sigma=10)
        assert np.allclose(mine, ref, atol=1e-10)


def test_lockin_batch(small_lattice):
    img, ks = small_lattice
    batch = np.asarray(gpa_lockin_batch(jnp.asarray(img), jnp.asarray(ks),
                                        sigma=10))
    for i, k in enumerate(ks):
        assert np.allclose(batch[i], ref_lockin(img, k[0], k[1], 10),
                           atol=1e-10)


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_wfr_sweep_matches_oracle(small_lattice, chunk):
    """The single-FFT shifted-Gaussian sweep must reproduce the literal
    modulate-per-candidate sweep (lockin, winning w, and gradient) in
    the image interior. (Within ~4 sigma of the borders the two
    formulations pick up the circular Gaussian wrap-around with a
    different — equally artifactual — phase; pipelines mask that rim.)
    """
    img, ks = small_lattice
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    m = 5 * sigma
    sl = np.s_[m:-m, m:-m]
    for k in ks[:2]:
        ref = ref_wfr(img, sigma, k[0], k[1], kw, kstep, with_grad=True)
        wxs = np.arange(k[0] - kw, k[0] + kw, kstep)
        wys = np.arange(k[1] - kw, k[1] + kw, kstep)
        wx, wy = np.meshgrid(wxs, wys, indexing="ij")
        wlist = np.stack([wx.ravel(), wy.ravel()], -1)
        mine = wfr_sweep(jnp.asarray(img), wlist, k, sigma,
                         with_grad=True, chunk=chunk)
        lock = np.array(mine["lockin"])[sl]
        assert np.allclose(lock, ref["lockin"][sl], atol=3e-6)
        assert np.allclose(np.array(mine["w"])[:, m:-m, m:-m],
                           ref["w"][:, m:-m, m:-m], atol=1e-12)
        assert np.allclose(np.array(mine["grad"])[sl], ref["grad"][sl],
                           atol=1e-6)


def test_api_variants_consistent(small_lattice):
    """wfr2 / optwfr2 / wfr2_grad_opt / wfr3 agree on the lock-in, as
    the reference's variant tests demand."""
    img, ks = small_lattice
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    sigma = 10
    g1 = gpa.wfr2(img, sigma, k[0], k[1], kw, kstep)
    g2 = gpa.wfr2_grad_opt(img, sigma, k[0], k[1], kw, kstep)
    only = gpa.wfr2_only_lockin(img, sigma, k[0], k[1], kw, kstep)
    assert np.allclose(np.asarray(g1["lockin"]), np.asarray(g2["lockin"]))
    assert np.allclose(np.asarray(g1["lockin"]), np.asarray(only))
    # wfr3 with the same grid and kref == k gives the same result
    wxs = np.arange(k[0] - kw, k[0] + kw, kstep)
    wys = np.arange(k[1] - kw, k[1] + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    klist = np.stack([wx.ravel(), wy.ravel()], -1)
    g3 = gpa.wfr3(img, sigma, klist, k)
    assert np.allclose(np.asarray(g3["lockin"]), np.asarray(g1["lockin"]))


def test_wfr4_continuity(small_lattice):
    img, ks = small_lattice
    k = ks[0]
    klists = gpa.generate_klists(ks, dk=0.01)
    g = gpa.wfr4(img, 10, klists[0][:40], k, dk=0.01)
    assert np.isfinite(np.asarray(g["lockin"])).all()
    assert np.asarray(g["w"]).shape == (2,) + img.shape


def _grid(k, kw, kstep):
    wxs = np.arange(k[0] - kw, k[0] + kw, kstep)
    wys = np.arange(k[1] - kw, k[1] + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    return np.stack([wx.ravel(), wy.ravel()], -1)


def test_wfr4_zoom_matches_full_fft(small_lattice):
    """The band-limited (zoom matmul) continuity sweep equals the
    full-FFT sequential path — lockin, winning w, and the analytic
    grads are consistent with the discrete ones in the interior."""
    img, ks = small_lattice
    k = ks[0]
    klists = gpa.generate_klists(ks, dk=0.01)
    klist = np.asarray(klists[0][:40])
    sigma = 10
    from pygpa_tpu.ops.wfr import _plan_zoom
    assert _plan_zoom(img.shape, klist, float(sigma)) is not None
    gz = wfr_sweep(jnp.asarray(img), klist, k, sigma,
                   continuity_dk=0.01, with_grad=True)
    gf = wfr_sweep(jnp.asarray(img), klist, k, sigma,
                   continuity_dk=0.01, with_grad=True, zoom=False)
    m = 5 * sigma
    sl = np.s_[m:-m, m:-m]
    same = (np.asarray(gz["w"])[:, m:-m, m:-m]
            == np.asarray(gf["w"])[:, m:-m, m:-m]).all(axis=0)
    assert same.mean() > 0.999
    lz = np.asarray(gz["lockin"])[sl][same]
    lf = np.asarray(gf["lockin"])[sl][same]
    assert np.allclose(lz, lf, atol=1e-6)
    # analytic vs np.gradient grads agree to the discretization error
    # of the central difference on the smooth demodulated phase
    dgrad = np.abs(np.asarray(gz["grad"])[sl][same]
                   - np.asarray(gf["grad"])[sl][same])
    assert np.quantile(dgrad, 0.99) < 5e-3


def test_phase_weight_multi_grad_matches_wfr_sweep():
    """wfr_sweep_phase_weight_multi(with_grad=True) returns per-peak
    phases/weights/gradients equal to the per-peak wfr_sweep grad
    path (rebase=False + the wfr2_grad_opt epilogue)."""
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.ops.wfr import (wfr_sweep,
                                   wfr_sweep_phase_weight_multi)

    size = 128
    r_k, theta = 0.1, 7.0
    img = np.array(hexlattice_gen(r_k, theta, order=1, size=size,
                                  dtype=np.float32))
    ks = np.array(generate_ks(r_k, theta))[:2]
    knorms = np.linalg.norm(ks, axis=1)
    sigma = int(np.ceil(1 / knorms.min()))
    dr = 2 * sigma
    kw = knorms.mean() / 2.5
    wlists = []
    for pk in ks:
        wxs = np.arange(pk[0] - kw, pk[0] + kw, kw / 2)
        wys = np.arange(pk[1] - kw, pk[1] + kw, kw / 2)
        wx, wy = np.meshgrid(wxs, wys, indexing="ij")
        wlists.append(np.stack([wx.ravel(), wy.ravel()], -1))

    img0 = jnp.asarray(img - img.mean())
    spectrum = jnp.fft.fft2(img0)
    ph, wt, gd = wfr_sweep_phase_weight_multi(
        img0, wlists, sigma, dr, spectrum=spectrum, with_grad=True,
        krefs=ks)
    assert gd.shape == (len(ks), size, size, 2)
    for i, (w, pk) in enumerate(zip(wlists, ks)):
        g = wfr_sweep(img0, w, pk, sigma, with_grad=True,
                      with_w=False, spectrum=spectrum, rebase=False)
        np.testing.assert_allclose(np.asarray(ph[i]),
                                   np.angle(np.asarray(g["lockin"])),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gd[i]),
                                   np.asarray(g["grad"]),
                                   rtol=0, atol=1e-6)


def test_multi_sweep_direct_windows_match_spectrum_path():
    """wfr_sweep_phase_weight_multi with spectrum=None must equal the
    explicit-spectrum call (the same zoom sweep after an internal
    fft2)."""
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    from pygpa_tpu.ops.wfr import wfr_sweep_phase_weight_multi

    size = 128
    r_k, theta = 0.1, 7.0
    img = np.array(hexlattice_gen(r_k, theta, order=1, size=size,
                                  dtype=np.float32))
    ks = np.array(generate_ks(r_k, theta))[:2]
    knorms = np.linalg.norm(ks, axis=1)
    sigma = int(np.ceil(1 / knorms.min()))
    kw = knorms.mean() / 2.5
    wlists = []
    for pk in ks:
        wxs = np.arange(pk[0] - kw, pk[0] + kw, kw / 2)
        wys = np.arange(pk[1] - kw, pk[1] + kw, kw / 2)
        wx, wy = np.meshgrid(wxs, wys, indexing="ij")
        wlists.append(np.stack([wx.ravel(), wy.ravel()], -1))
    img0 = jnp.asarray(img - img.mean())
    dr = 2 * sigma
    ph0, wt0 = wfr_sweep_phase_weight_multi(
        img0, wlists, sigma, dr, spectrum=jnp.fft.fft2(img0))
    ph1, wt1 = wfr_sweep_phase_weight_multi(img0, wlists, sigma, dr)
    np.testing.assert_array_equal(np.asarray(ph0), np.asarray(ph1))
    np.testing.assert_array_equal(np.asarray(wt0), np.asarray(wt1))


# --- the zoom (band-limited matmul) sweep against the float64 oracle ---

@pytest.fixture(scope="module")
def oracle_k0(small_lattice):
    """ref_wfr for the first Bragg peak of small_lattice (with grads)."""
    img, ks = small_lattice
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ref = ref_wfr(img, sigma, k[0], k[1], kw, kstep, with_grad=True)
    return k, _grid(k, kw, kstep), sigma, ref


@pytest.mark.parametrize("chunk", [2, 3, 5, 7])
def test_zoom_sweep_matches_oracle_without_grad(small_lattice, oracle_k0,
                                                chunk):
    """The zoom sweep (chunk sizes that do and do not divide the 36
    candidates, so the sentinel padding is exercised) reproduces the
    oracle's lock-in and winning w in the interior."""
    img, _ = small_lattice
    k, wlist, sigma, ref = oracle_k0
    from pygpa_tpu.ops.wfr import _plan_zoom
    assert _plan_zoom(img.shape, wlist, float(sigma)) is not None
    mine = wfr_sweep(jnp.asarray(img), wlist, k, sigma, chunk=chunk,
                     zoom=True)
    m = 5 * sigma
    sl = np.s_[m:-m, m:-m]
    assert "grad" not in mine
    assert np.allclose(np.asarray(mine["lockin"])[sl], ref["lockin"][sl],
                       atol=3e-6)
    assert np.allclose(np.asarray(mine["w"])[:, m:-m, m:-m],
                       ref["w"][:, m:-m, m:-m], atol=1e-12)


@pytest.mark.parametrize("with_grad", [False, True])
def test_zoom_sweep_equals_full_fft_sweep(small_lattice, oracle_k0,
                                          with_grad):
    """Band-limited and full-FFT sweeps agree everywhere (including the
    rim) up to the window truncation, G < 3e-10 outside the window."""
    img, _ = small_lattice
    k, wlist, sigma, _ = oracle_k0
    gz = wfr_sweep(jnp.asarray(img), wlist, k, sigma, zoom=True,
                   with_grad=with_grad)
    gf = wfr_sweep(jnp.asarray(img), wlist, k, sigma, zoom=False,
                   with_grad=with_grad)
    scale = np.abs(np.asarray(gf["lockin"])).max()
    assert np.abs(np.asarray(gz["lockin"])
                  - np.asarray(gf["lockin"])).max() < 1e-8 * scale
    assert np.array_equal(np.asarray(gz["w"]), np.asarray(gf["w"]))
    if with_grad:
        assert np.allclose(np.asarray(gz["grad"]), np.asarray(gf["grad"]),
                           atol=1e-7)


def test_zoom_sweep_over_48_candidates(small_lattice):
    """An 8x8 = 64-candidate grid (more than one chunk of every size the
    pipeline uses) matches the oracle's winners and lock-in."""
    img, ks = small_lattice
    k = ks[1]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 4
    wlist = _grid(k, kw, kstep)
    assert wlist.shape[0] > 48
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ref = ref_wfr(img, sigma, k[0], k[1], kw, kstep)
    mine = wfr_sweep(jnp.asarray(img), wlist, k, sigma, chunk=8,
                     zoom=True)
    m = 5 * sigma
    sl = np.s_[m:-m, m:-m]
    assert np.allclose(np.asarray(mine["w"])[:, m:-m, m:-m],
                       ref["w"][:, m:-m, m:-m], atol=1e-12)
    assert np.allclose(np.asarray(mine["lockin"])[sl], ref["lockin"][sl],
                       atol=3e-6)


def test_zoom_sweep_rectangular_image():
    """Non-square frames (each axis has its own window) match the
    oracle."""
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks
    r_k = 0.15
    img = np.array(hexlattice_gen(r_k, 13.0, order=1, size=352,
                                  dtype=np.float64))[:256]
    img = img - img.mean()
    ks = np.array(generate_ks(r_k, 13.0))[:3]
    k = ks[2]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    from pygpa_tpu.ops.wfr import _plan_zoom
    wlist = _grid(k, kw, kstep)
    plan = _plan_zoom(img.shape, wlist, float(sigma))
    assert plan is not None and plan[0].shape != plan[1].shape
    ref = ref_wfr(img, sigma, k[0], k[1], kw, kstep)
    mine = wfr_sweep(jnp.asarray(img), wlist, k, sigma, zoom=True)
    m = 5 * sigma
    sl = np.s_[m:-m, m:-m]
    assert np.allclose(np.asarray(mine["lockin"])[sl], ref["lockin"][sl],
                       atol=3e-6)


def test_zoom_window_widening_is_exact(small_lattice, oracle_k0):
    """Widening the spectrum window (align=32 -> the default 64) only
    adds bins of ~zero Gaussian weight: the sweep is unchanged to
    float64 rounding."""
    from pygpa_tpu.ops.wfr import _plan_zoom, _wfr_sweep_zoom
    img, _ = small_lattice
    k, wlist, sigma, _ = oracle_k0
    spectrum = jnp.fft.fft2(jnp.asarray(img))
    tight = _plan_zoom(img.shape, wlist, float(sigma), align=32)
    wide = _plan_zoom(img.shape, wlist, float(sigma))
    assert wide[0].shape[0] > tight[0].shape[0]
    outs = [_wfr_sweep_zoom(spectrum, jnp.asarray(wlist),
                            jnp.asarray(p[0]), jnp.asarray(p[1]),
                            float(sigma), False, 4) for p in (tight, wide)]
    assert np.array_equal(np.asarray(outs[0][2]), np.asarray(outs[1][2]))
    scale = np.abs(np.asarray(outs[0][1])).max()
    assert np.abs(np.asarray(outs[0][1])
                  - np.asarray(outs[1][1])).max() < 1e-9 * scale


def test_multi_peak_matches_per_peak(small_lattice):
    """wfr_sweep_phase_weight_multi stacks exactly the per-peak
    wfr_sweep_phase_weight results."""
    from pygpa_tpu.ops.wfr import (wfr_sweep_phase_weight,
                                   wfr_sweep_phase_weight_multi)
    img, ks = small_lattice
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    wlists = [_grid(k, kw, kw / 3) for k in ks]
    img0 = jnp.asarray(img)
    ph, wt = wfr_sweep_phase_weight_multi(img0, wlists, sigma, 2 * sigma,
                                          chunk=4)
    assert ph.shape == wt.shape == (3,) + img.shape
    for i, w in enumerate(wlists):
        p1, w1 = wfr_sweep_phase_weight(img0, w, ks[i], sigma, 2 * sigma,
                                        chunk=4)
        np.testing.assert_array_equal(np.asarray(ph[i]), np.asarray(p1))
        np.testing.assert_array_equal(np.asarray(wt[i]), np.asarray(w1))


@pytest.mark.parametrize("dr", [1, 9])
def test_phase_weight_rim_mask(small_lattice, oracle_k0, dr):
    """weight = |lockin| * (interior mask + 1e-6) with a dr-wide rim
    (extract_displacement_field's weighting), phase = angle of the
    demodulated lock-in."""
    from pygpa_tpu.ops.wfr import wfr_sweep_phase_weight
    img, _ = small_lattice
    k, wlist, sigma, _ = oracle_k0
    ph, wt = wfr_sweep_phase_weight(jnp.asarray(img), wlist, k, sigma, dr)
    g = wfr_sweep(jnp.asarray(img), wlist, k, sigma, rebase=False)
    lock = np.asarray(g["lockin"])
    mask = np.zeros(img.shape)
    mask[dr:-dr, dr:-dr] = 1.0
    np.testing.assert_allclose(np.asarray(wt), np.abs(lock) * (mask + 1e-6),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(np.asarray(ph), np.angle(lock), atol=1e-12)


def test_phase_weight_rejects_empty_rim(small_lattice, oracle_k0):
    from pygpa_tpu.ops.wfr import wfr_sweep_phase_weight
    img, _ = small_lattice
    k, wlist, sigma, _ = oracle_k0
    with pytest.raises(ValueError, match="dr >= 1"):
        wfr_sweep_phase_weight(jnp.asarray(img), wlist, k, sigma, 0)


def test_traced_wlist_falls_back_to_full_fft(small_lattice, oracle_k0):
    """A traced candidate list cannot be planned: zoom='auto' warns and
    takes the full-FFT sweep (same values), zoom=True refuses."""
    import jax
    img, _ = small_lattice
    k, wlist, sigma, _ = oracle_k0
    with pytest.warns(UserWarning, match="traced"):
        out = jax.jit(lambda w: wfr_sweep(jnp.asarray(img), w, k,
                                          sigma)["lockin"])(
            jnp.asarray(wlist))
    ref = wfr_sweep(jnp.asarray(img), wlist, k, sigma, zoom=False)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref["lockin"]),
                               atol=1e-12)
    with pytest.raises(ValueError, match="concrete"):
        jax.jit(lambda w: wfr_sweep(jnp.asarray(img), w, k, sigma,
                                    zoom=True)["lockin"])(
            jnp.asarray(wlist))


def test_zoom_true_refuses_a_wide_window():
    """zoom=True raises when the bandpass window spans most of the
    spectrum (no plan), instead of silently running the full FFT."""
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.normal(size=(32, 32)))
    wlist = _grid(np.array([0.2, 0.1]), 0.1, 0.05)
    with pytest.raises(ValueError, match="worthwhile"):
        wfr_sweep(img, wlist, np.array([0.2, 0.1]), 2, zoom=True)


def test_return_absq_is_winner_amplitude(small_lattice, oracle_k0):
    """return_absq gives |demodulated lock-in|^2 of the winner."""
    img, _ = small_lattice
    k, wlist, sigma, _ = oracle_k0
    g = wfr_sweep(jnp.asarray(img), wlist, k, sigma, rebase=False,
                  return_absq=True, with_w=False)
    assert "w" not in g
    np.testing.assert_allclose(np.asarray(g["absq"]),
                               np.abs(np.asarray(g["lockin"])) ** 2,
                               rtol=1e-12, atol=1e-300)


def test_multi_grad_requires_krefs(small_lattice, oracle_k0):
    from pygpa_tpu.ops.wfr import wfr_sweep_phase_weight_multi
    img, _ = small_lattice
    _, wlist, sigma, _ = oracle_k0
    with pytest.raises(ValueError, match="krefs"):
        wfr_sweep_phase_weight_multi(jnp.asarray(img), [wlist], sigma,
                                     2 * sigma, with_grad=True)
