"""Synthetic lattice rendering (latticegen equivalent), jit-compiled.

generate_ks mirrors latticegen.generate_ks's contract as used by the
reference (returns sym+1 vectors, trailing zero vector; callers slice
[:3] or [:-1] — see /root/reference/tests/test_geometric_phase_analysis.
py:33-40, property_extract.py:121,582-586). hexlattice_gen renders a
(possibly anisotropic, possibly displaced) hexagonal lattice as a sum
of plane waves over reciprocal-lattice shells; where latticegen builds
a lazy dask graph this version is a single fused XLA program
(lax.scan over k-vectors), vmappable and fast at 4096^2+.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .transformations import anisotropy_matrix


def generate_ks(r_k, theta, kappa=1.0, psi=0.0, sym=6):
    """k-vectors of a (kappa, psi)-anisotropic lattice.

    Parameters mirror latticegen.generate_ks: magnitude `r_k` (unit
    cells / pixel), rotation `theta` in degrees, anisotropy magnitude
    `kappa` along direction `psi` (degrees), `sym`-fold symmetry.

    Returns (sym+1, 2): the sym rotated vectors followed by the zero
    vector (the central spot), so callers can slice [:-1] or [:3]
    exactly as with latticegen.
    """
    angles = jnp.deg2rad(jnp.asarray(theta, jnp.result_type(float))) \
        + jnp.arange(sym) * 2 * jnp.pi / sym
    ks = jnp.asarray(r_k) * jnp.stack([jnp.cos(angles), jnp.sin(angles)], -1)
    # exact matmul: a reduced-precision default (bf16 or TF32 on
    # accelerators) would corrupt k-geometry by ~1e-3 relative (~1 px
    # of apparent displacement at image scale)
    ks = jnp.matmul(ks, anisotropy_matrix(kappa, psi).T,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.concatenate([ks, jnp.zeros((1, 2), ks.dtype)])


def _shell_vectors(order):
    """Integer reciprocal-lattice combinations n1*k1 + n2*k2 grouped by
    shell, for the unit hexagonal basis (k1 at 0 deg, k2 at 60 deg).
    Returns host-side (coeffs (P,2) int, amplitudes (P,)) for shells up
    to `order`, excluding the zero vector; one vector per +/- pair."""
    k1 = np.array([1.0, 0.0])
    k2 = np.array([np.cos(np.pi / 3), np.sin(np.pi / 3)])
    seen = {}
    for n1 in range(-order * 2, order * 2 + 1):
        for n2 in range(-order * 2, order * 2 + 1):
            if n1 == 0 and n2 == 0:
                continue
            # one representative per +/- pair (cos is even)
            key = (n1, n2) if (n1 > 0 or (n1 == 0 and n2 > 0)) else (-n1, -n2)
            seen[key] = np.linalg.norm(key[0] * k1 + key[1] * k2)
    norms = sorted(set(round(v, 9) for v in seen.values()))
    shells = norms[:order]
    coeffs, amps = [], []
    for (n1, n2), norm in seen.items():
        r = round(norm, 9)
        if r in shells:
            s = shells.index(r)
            coeffs.append((n1, n2))
            # factor 2: each representative stands for the +/- pair
            # (latticegen sums all sym vectors; cos is even)
            amps.append(2.0 * 0.4 ** s)
    return np.array(coeffs, np.int32), np.array(amps)


@partial(jax.jit, static_argnames=("shape",))
def _render(ks, amps, shape, shift, dtype_probe):
    dt = dtype_probe.dtype
    n, m = shape
    x = (jnp.arange(n, dtype=dt) - n // 2)[:, None]
    y = (jnp.arange(m, dtype=dt) - m // 2)[None, :]
    if shift is None:
        ux = uy = jnp.zeros((), dt)
    else:
        ux, uy = shift[0].astype(dt), shift[1].astype(dt)
    xs = x + ux
    ys = y + uy

    def body(acc, ka):
        k, a = ka
        acc = acc + a * jnp.cos(2 * jnp.pi * (k[0] * xs + k[1] * ys))
        return acc, None

    init = jnp.zeros((n, m), dt)
    acc, _ = jax.lax.scan(body, init, (ks.astype(dt), amps.astype(dt)))
    return acc


def anylattice_gen(ks, order_amplitudes=None, size=500, shift=None,
                   dtype=None):
    """Render sum_i a_i cos(2 pi k_i . (r + u(r))) on a centered grid.

    `ks` is (P, 2); `shift` an optional (2, N, M) displacement field u
    (the lattice is sampled at r + u(r), matching latticegen's `shift`
    semantics relied on by the displacement-field round-trip tests).
    """
    ks = jnp.asarray(ks)
    if order_amplitudes is None:
        order_amplitudes = jnp.ones(ks.shape[0], ks.dtype)
    shape = (size, size) if np.isscalar(size) else tuple(size)
    dt = jnp.zeros((), dtype or ks.dtype)
    return _render(ks, jnp.asarray(order_amplitudes), shape, shift, dt)


def hexlattice_gen(r_k, theta, order=1, size=500, kappa=1.0, psi=0.0,
                   shift=None, dtype=None):
    """Hexagonal lattice image with `order` reciprocal shells.

    Drop-in for latticegen.hexlattice_gen as the reference tests use it
    (tests/test_geometric_phase_analysis.py:25-41): anisotropy
    (kappa, psi), optional displacement field `shift` (2, N, M).
    Returns the rendered (size, size) array (eager, no .compute()).
    """
    coeffs, amps = _shell_vectors(order)
    base = generate_ks(r_k, theta, kappa=kappa, psi=psi, sym=6)
    k1, k2 = base[0], base[1]
    ks = coeffs[:, :1] * k1[None, :] + coeffs[:, 1:] * k2[None, :]
    return anylattice_gen(ks, amps, size=size, shift=shift, dtype=dtype)
