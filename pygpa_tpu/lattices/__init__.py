"""In-repo lattice generation (replaces the external `latticegen` dep).

The reference depends on latticegen (same author, installed from git in
its CI) for synthetic test lattices and for the Kerelsky fit model
functions (/root/reference/pyGPA/property_extract.py:6,121,582-586).
This subpackage provides a device-native equivalent: 2x2 lattice
transformations and jit-compiled plane-wave lattice rendering with
displacement-field support.
"""
from .transformations import (  # noqa: F401
    rotation_matrix, rotate, scaling_matrix, strain_matrix,
    a_0_to_r_k, r_k_to_a_0, epsilon_to_kappa, kappa_to_epsilon,
    apply_transformation_matrix, anisotropy_matrix,
)
from .generate import generate_ks, hexlattice_gen, anylattice_gen  # noqa: F401
