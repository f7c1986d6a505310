"""2x2 lattice transformation matrices.

Conventions (fixed, used consistently across pygpa_tpu):
 - vectors are rows; matrices act as ``vecs @ M.T`` (i.e. k -> M k).
 - rotation_matrix(angle) is counter-clockwise, [[c, -s], [s, c]],
   angle in radians.
 - scaling_matrix(kappa) = diag(kappa, 1): anisotropic stretch of the
   x-axis, used to build test Jacobians.
 - anisotropy in *k-space* for a lattice with strain magnitude kappa
   along direction psi is V^T diag(1/kappa, 1) V (real-space stretch
   by kappa along psi shrinks k along psi); verified to round-trip
   through the property-extraction SVD formulas.
 - strain_matrix(epsilon, delta): k-space transform of uniaxial
   heterostrain epsilon with Poisson ratio delta:
   diag(1/(1+eps), 1/(1-delta*eps)).
 - epsilon_to_kappa converts heterostrain to the (r_k, kappa)
   parametrization: kappa = (1+eps)/(1-delta*eps),
   r_k' = r_k/(1-delta*eps).

These play the role latticegen.transformations plays for the reference
(used at /root/reference/pyGPA/property_extract.py:582-586,647-660,
692-693; tests tests/test_property_extract.py:7).
"""
import jax
import jax.numpy as jnp


def _mm(a, b):
    # exact matmul (accelerator defaults are bf16/TF32 — geometry must
    # stay float32)
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

DEFAULT_POISSON = 0.16


def rotation_matrix(angle):
    """CCW rotation matrix for `angle` in radians. Batched over leading
    dims of `angle` (output shape angle.shape + (2, 2))."""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack([jnp.stack([c, -s], -1),
                      jnp.stack([s, c], -1)], -2)


def rotate(vecs, angle):
    """Rotate row-vector(s) CCW by `angle` radians."""
    return jnp.matmul(jnp.asarray(vecs), rotation_matrix(angle).T,
                      precision=jax.lax.Precision.HIGHEST)


def scaling_matrix(kappa, dims=2):
    """diag(kappa, 1, ..., 1)."""
    d = jnp.ones(dims)
    return jnp.diag(d.at[0].set(kappa))


def anisotropy_matrix(kappa, psi):
    """k-space anisotropy: V(psi)^T diag(1/kappa, 1) V(psi),
    psi in degrees."""
    V = rotation_matrix(jnp.deg2rad(psi))
    D = jnp.diag(jnp.array([1.0 / kappa, 1.0]))
    return _mm(_mm(V.T, D), V)


def strain_matrix(epsilon, delta=DEFAULT_POISSON, axis=0):
    """k-space transform of real-space uniaxial strain `epsilon` along
    `axis` with Poisson contraction delta*epsilon perpendicular."""
    d = jnp.array([1.0 / (1.0 + epsilon), 1.0 / (1.0 - delta * epsilon)])
    if axis == 1:
        d = d[::-1]
    return jnp.diag(d)


def a_0_to_r_k(a_0):
    """Lattice constant (nm or px) -> hexagonal lattice k-magnitude in
    unit cells per pixel: r_k = 2 / (sqrt(3) a_0), the reciprocal of the
    (sqrt(3)/2 a_0) line spacing (cf. f2angle,
    geometric_phase_analysis.py:352-368)."""
    return 2.0 / (jnp.sqrt(3.0) * a_0)


def r_k_to_a_0(r_k):
    """Inverse of a_0_to_r_k."""
    return 2.0 / (jnp.sqrt(3.0) * r_k)


def epsilon_to_kappa(r_k, epsilon, delta=DEFAULT_POISSON):
    """Convert (r_k, heterostrain epsilon) to the (r_k', kappa)
    anisotropy parametrization used by generate_ks."""
    return r_k / (1.0 - delta * epsilon), \
        (1.0 + epsilon) / (1.0 - delta * epsilon)


def kappa_to_epsilon(kappa, delta=DEFAULT_POISSON):
    """Inverse relation: epsilon = (kappa-1)/(1+delta*kappa)
    (cf. calc_eps_from_phasegradient, property_extract.py:281-293)."""
    return (kappa - 1.0) / (1.0 + delta * kappa)


def apply_transformation_matrix(vecs, matrix):
    """Apply a 2x2 transform to row-vector(s): vecs @ matrix.T."""
    return jnp.matmul(jnp.asarray(vecs), jnp.asarray(matrix).T,
                      precision=jax.lax.Precision.HIGHEST)
