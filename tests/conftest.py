"""Test configuration: CPU backend with a virtual 8-device mesh (the
multi-device sharding logic runs on the host), float64 enabled so
reference-grade numerics can be checked exactly.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Optional persistent compilation cache (opt-in): JAX itself reads
# JAX_COMPILATION_CACHE_DIR; the suite is compile-bound, so cache even
# short compiles when it is set.
if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def gaussiandeform():
    """Analytic Gaussian-envelope x-shift displacement field (500^2),
    mirroring the reference fixture
    (/root/reference/tests/test_geometric_phase_analysis.py:12-17)."""
    size = 500
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    xshift = 0.5 * xp * np.exp(-0.5 * ((xp / (2 * S / 8)) ** 2
                                       + 1.2 * (yp / (2 * S / 6)) ** 2))
    return np.stack((xshift, np.zeros_like(xshift)), axis=0)


@pytest.fixture(scope="session")
def testset_gaussian(gaussiandeform):
    """Synthetic hexagonal test set: clean lattice, deformed lattice,
    smoothed noise, true k-vectors (reference fixture
    tests/test_geometric_phase_analysis.py:25-41, with a seeded RNG)."""
    import scipy.ndimage as ndi
    from pygpa_tpu.lattices import hexlattice_gen, generate_ks

    r_k, xi0, psi, kappa, order, S = 0.1, 7.0, 0.0, 1.001, 2, 500
    original = np.asarray(hexlattice_gen(r_k, xi0, order, size=S,
                                         kappa=kappa, psi=psi,
                                         dtype=np.float64))
    deformed = np.asarray(hexlattice_gen(r_k, xi0, order, size=S,
                                         kappa=kappa, psi=psi,
                                         shift=gaussiandeform,
                                         dtype=np.float64))
    rng = np.random.default_rng(42)
    noise = ndi.gaussian_filter(5 * rng.normal(size=deformed.shape),
                                sigma=0.5)
    ori_ks = np.asarray(generate_ks(r_k, xi0, kappa=kappa, psi=psi))[:-1]
    return original, deformed, noise, ori_ks
