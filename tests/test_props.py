"""Property-extraction algebra: hypothesis round trips mirroring
/root/reference/tests/test_property_extract.py."""
import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

import pygpa_tpu.props as pe
from pygpa_tpu.core.mathtools import periodic_difference as pd_jnp
from pygpa_tpu.lattices.transformations import (rotation_matrix,
                                                scaling_matrix, a_0_to_r_k)
from pygpa_tpu.lattices import generate_ks
from pygpa_tpu.gpa.kgeometry import f2angle


def periodic_difference(x, y, period):
    return float(np.asarray(pd_jnp(x, y, period=period)))


@settings(deadline=None, max_examples=60)
@given(theta=st.floats(0.0, 360.0),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1e4, exclude_min=True),
       a=st.floats(1e-10, 1e10, exclude_min=True))
def test_props_from_J(theta, psi, kappa, a):
    W = np.asarray(rotation_matrix(np.deg2rad(theta)))
    V = np.asarray(rotation_matrix(np.deg2rad(psi)))
    D = np.asarray(scaling_matrix(kappa)) * a
    Jac_ori = V.T @ D @ V @ W
    props = np.asarray(pe.props_from_Jac(jnp.asarray(Jac_ori)))
    assert np.isclose(periodic_difference(props[0], theta, 360), 0,
                      atol=1e-6)
    assert np.isclose(periodic_difference(props[1], psi, 180), 0,
                      atol=1e-5)
    assert np.isclose(props[2], a)
    assert np.isclose(props[3], kappa)
    props2 = np.asarray(pe.props_from_J(jnp.asarray(Jac_ori / a)
                                        - jnp.eye(2), refscale=a))
    assert np.isclose(periodic_difference(props2[0], theta, 360), 0,
                      atol=1e-6)
    assert np.isclose(props2[2], a) and np.isclose(props2[3], kappa)


@settings(deadline=None, max_examples=60)
@given(theta=st.floats(0.0, 360.0),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1e10, exclude_min=True),
       a=st.floats(1e-5, 1e5, exclude_min=True))
def test_svd2x2_assumptions(theta, psi, kappa, a):
    """The closed-form SVD reproduces the LAPACK conventions the
    reference's sign-fixing relies on
    (tests/test_property_extract.py:47-64)."""
    W = np.asarray(rotation_matrix(np.deg2rad(theta)))
    V = np.asarray(rotation_matrix(np.deg2rad(psi)))
    D = np.asarray(scaling_matrix(kappa)) * a
    J_ori = V.T @ D @ V @ W
    u, s, v = [np.asarray(z) for z in pe.svd2x2(jnp.asarray(J_ori))]
    # valid svd, descending
    assert np.allclose(u @ (s[..., None] * v), J_ori,
                       rtol=1e-10, atol=1e-10 * a * kappa)
    assert s[0] >= s[1] >= 0
    # the reference's canonicalization recovers the factors
    vv = np.sign(np.diag(u)) * v
    uu = (np.sign(np.diag(u)) * u).T
    angle = (uu @ vv).T
    assert np.allclose(angle, W, atol=1e-7)
    assert np.allclose(np.diag(s), D / a * a, rtol=1e-6)
    # anisotropy frame defined modulo 180 degrees: uu == +/-V
    assert (np.allclose(uu, V, atol=1e-7)
            or np.allclose(uu, -V, atol=1e-7))


@settings(deadline=None, max_examples=60)
@given(theta=st.floats(-180.0 + 1e-3, 180.0),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1e3, exclude_min=True),
       a=st.floats(1e-9, 1e9, exclude_min=True))
def test_calc_props_from_kvecs(theta, psi, kappa, a):
    kvecs = np.asarray(generate_ks(a, theta, kappa=kappa, psi=psi))[:3]
    props = np.asarray(pe.calc_props_from_kvecs4(jnp.asarray(kvecs)))
    assert np.isclose(periodic_difference(props[0], theta, 60), 0,
                      atol=1e-3)
    assert np.isclose(periodic_difference(props[1], psi, 180), 0,
                      atol=1e-2)
    assert np.isclose(props[2], a)
    assert np.isclose(props[3], kappa)


@settings(deadline=None, max_examples=60)
@given(theta=st.floats(1e-2, 60 - 1e-2, exclude_min=True),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1.1, exclude_min=True),
       a=st.floats(1e-9, 1e9, exclude_min=True))
def test_kvecs2Jac(theta, psi, kappa, a):
    ks = np.asarray(generate_ks(a, theta, kappa=kappa, psi=psi))[:3]
    Jac = np.asarray(pe.kvecs2Jac(jnp.asarray(ks), standardize=False))
    J = np.asarray(pe.kvecs2J(jnp.asarray(ks), standardize=False))
    assert np.allclose(Jac, J + np.eye(2))
    r_kl, theta_0, symmetry = [np.asarray(z) for z in
                               pe.get_initial_props(jnp.asarray(ks))]
    krefs = np.asarray(generate_ks(float(r_kl), float(theta_0),
                                   sym=int(symmetry)))[:-1]
    krefs2 = krefs @ Jac.T
    abs_diffs = np.linalg.norm(krefs2[None] - ks[:, None], axis=-1) \
        .min(axis=1)
    assert np.allclose(abs_diffs / r_kl, 0, atol=1e-3)


@settings(deadline=None, max_examples=40)
@given(theta=st.floats(1e-6, 60 - 1e-6, exclude_min=True),
       nmperpixel=st.floats(1e-9, 1e9, exclude_min=True),
       a=st.floats(1e-9, 1e9, exclude_min=True))
def test_f2angle(theta, nmperpixel, a):
    ks1 = np.asarray(generate_ks(float(a_0_to_r_k(a / nmperpixel)), 0.0))
    ks2 = np.asarray(generate_ks(float(a_0_to_r_k(a / nmperpixel)), theta))
    moire_ks = ks1[:3] - ks2[:3]
    r_k, theta_0, symmetry = pe.get_initial_props(jnp.asarray(moire_ks))
    theta_iso = float(np.asarray(f2angle(r_k, nmperpixel=nmperpixel,
                                         a_0=a)))
    assert np.isclose(theta_iso, theta, rtol=1e-6, atol=1e-9)


def test_props_field_batched():
    """props_from_Jac over an (N, M, 2, 2) field — one fused program."""
    rng = np.random.default_rng(0)
    thetas = rng.uniform(0, 60, size=(8, 8))
    Jacs = np.zeros((8, 8, 2, 2))
    for i in range(8):
        for j in range(8):
            Jacs[i, j] = np.asarray(
                rotation_matrix(np.deg2rad(thetas[i, j])))
    props = np.asarray(pe.props_from_Jac(jnp.asarray(Jacs)))
    assert props.shape == (4, 8, 8)
    d = np.asarray(pd_jnp(props[0], thetas, period=360))
    assert np.allclose(d, 0, atol=1e-6)
    assert np.allclose(props[3], 1.0, atol=1e-8)


def test_u2J_and_phases2J_consistency(gaussiandeform):
    """u2J of a smooth field matches phases2J of the corresponding
    exact phases."""
    ks = np.asarray(generate_ks(0.05, 10.0))[:3]
    u = jnp.asarray(gaussiandeform[:, 100:200, 100:200])
    J_u = np.asarray(pe.u2J(u, 1.0))
    # phases of the *extracted* u convention: phi = +2 pi K u
    phases = 2 * np.pi * np.einsum("kc,cnm->knm", ks, np.asarray(u))
    weights = np.ones_like(phases)
    J_p = np.asarray(pe.phases2J(jnp.asarray(ks), jnp.asarray(phases),
                                 jnp.asarray(weights), 1.0))
    assert np.allclose(J_u[2:-2, 2:-2], J_p[2:-2, 2:-2], atol=1e-6)


def test_plane_layout_matches_jac_layout():
    """props_from_planes / props_from_u == props_from_Jac / u2J path
    (the plane layout big fields use)."""
    import pygpa_tpu.props as pe2
    rng = np.random.default_rng(7)
    u = rng.normal(size=(2, 24, 24)).cumsum(axis=1) * 0.01
    J = np.asarray(pe2.u2J(jnp.asarray(u), 2.0))
    p_jac = np.asarray(pe2.props_from_Jac(jnp.asarray(J) + jnp.eye(2)))
    p_pl = np.asarray(pe2.props_from_u(jnp.asarray(u), 2.0))
    assert np.allclose(p_jac, p_pl, atol=1e-10)
    planes = pe2.u2J_planes(jnp.asarray(u), 2.0)
    p_pl2 = np.asarray(pe2.props_from_planes(*planes))
    assert np.allclose(p_jac, p_pl2, atol=1e-10)
