"""Phase unwrap: equivalence with the NumPy oracle and analytic
round trips (mirrors /root/reference/tests/test_phase_unwrap.py)."""
import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

import pygpa_tpu.solvers.unwrap as pu
from reference_impls import ref_phase_unwrap, ref_phase_unwrap_prediff

N = 128


def _plane(N):
    xx, yy = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return (yy + xx) / (4 * np.sqrt(2))


@settings(deadline=None, max_examples=12)
@given(kmax=st.integers(1, 30))
def test_phase_unwrap_matches_oracle(kmax):
    psi0 = _plane(N)
    psi = (psi0 + np.pi) % (2 * np.pi) - np.pi
    weight = np.ones_like(psi)
    ref = ref_phase_unwrap(psi, weight, kmax=kmax)
    mine = np.asarray(pu.phase_unwrap(jnp.asarray(psi), jnp.asarray(weight),
                                      kmax=kmax))
    assert np.allclose(mine, ref, atol=1e-8)
    # unweighted terminates in one exact Poisson solve
    mine_u = np.asarray(pu.phase_unwrap(jnp.asarray(psi), None, kmax=kmax))
    assert np.allclose(mine_u - mine_u.mean(), psi0 - psi0.mean(),
                       atol=1e-8)


def test_phase_unwrap_gaussian_weight_equivalence():
    psi0 = _plane(N)
    psi = (psi0 + np.pi) % (2 * np.pi) - np.pi
    xx, yy = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    gaussian = np.exp(-((xx - N // 2) ** 2 + (yy - N // 2) ** 2)
                      / (0.3 * N ** 2))
    w = np.asarray(pu.phase_unwrap(jnp.asarray(psi), jnp.asarray(gaussian)))
    u = np.asarray(pu.phase_unwrap(jnp.asarray(psi), None))
    assert np.allclose(w, u, atol=1e-6)


@settings(deadline=None, max_examples=12)
@given(kmax=st.integers(1, 30))
def test_phase_unwrap_prediff_matches_oracle(kmax):
    psi0 = _plane(N)
    psi = (psi0 + np.pi) % (2 * np.pi) - np.pi
    dx = np.diff(psi, axis=1)
    dy = np.diff(psi, axis=0)
    weight = np.ones_like(psi)
    ref = ref_phase_unwrap_prediff(dx, dy, weight, kmax=kmax)
    mine = np.asarray(pu.phase_unwrap_prediff(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(weight), kmax=kmax))
    assert np.allclose(mine, ref, atol=1e-8)
    assert np.allclose(mine - mine.mean(), psi0 - psi0.mean(), atol=1e-6)


def test_weighted_unwrap_ignores_noisy_region():
    """Weights steer the integration: corrupt a corner, weight it to
    ~zero, and the rest must still unwrap to the plane."""
    psi0 = _plane(N)
    rng = np.random.default_rng(0)
    psi0_noisy = psi0.copy()
    psi0_noisy[:20, :20] += rng.normal(size=(20, 20)) * 3
    psi = (psi0_noisy + np.pi) % (2 * np.pi) - np.pi
    weight = np.ones_like(psi)
    weight[:22, :22] = 1e-4
    res = np.asarray(pu.phase_unwrap(jnp.asarray(psi), jnp.asarray(weight),
                                     kmax=200))
    good = np.s_[30:, 30:]
    err = (res - psi0)[good]
    assert np.abs(err - err.mean()).max() < 1e-2



def test_mg_schedule_knob_validation():
    """A bad unwrap_mg_final-style string in the schedule raises a
    helpful ValueError instead of a bare comparison TypeError."""
    import pytest
    from pygpa_tpu.solvers.unwrap import phase_unwrap_prediff_mg
    dx = jnp.zeros((64, 63))
    dy = jnp.zeros((63, 64))
    w = jnp.ones((64, 64))
    with pytest.raises(ValueError, match="unwrap_mg_final"):
        phase_unwrap_prediff_mg(dx, dy, w,
                                schedule=((4, 2), (1, "cg")))
    # the valid spellings still run
    for final in (1, "v", "vv"):
        out = phase_unwrap_prediff_mg(dx, dy, w,
                                      schedule=((4, 2), (1, final)))
        assert out.shape == (64, 64)

def test_phase_unwrap_mg_beats_cg25_on_weighted_fixture():
    """phase_unwrap_mg (the production multigrid path exposed at the
    phase_unwrap surface) must land at least as close to the CONVERGED
    weighted solution as 25 plain CG iterations do. On lock-in-like
    weights the weighted Poisson system is badly conditioned — this is
    the regime that motivated the benchmark config-3 switch (2048^2
    fixture: mg 0.12 rad vs CG-25 0.89 rad against a 200-iteration
    reference)."""
    N2 = 384
    xx, yy = np.meshgrid(np.arange(N2), np.arange(N2), indexing="ij")
    psi0 = (0.15 * (xx + yy)
            + 40.0 * np.exp(-(((xx - N2 / 2) / (N2 / 3)) ** 2
                              + ((yy - N2 / 2) / (N2 / 4)) ** 2)))
    psi = (psi0 + np.pi) % (2 * np.pi) - np.pi
    # lattice-amplitude-like weights: strong oscillation + floor
    w = 0.05 + np.abs(np.cos(0.8 * xx) * np.cos(0.8 * yy))
    truth = np.asarray(pu.phase_unwrap(jnp.asarray(psi), jnp.asarray(w),
                                       kmax=800))
    cg25 = np.asarray(pu.phase_unwrap(jnp.asarray(psi), jnp.asarray(w),
                                      kmax=25))
    mg = np.asarray(pu.phase_unwrap_mg(jnp.asarray(psi), jnp.asarray(w)))

    def err(a):
        d = a - truth
        d -= d.mean()
        return np.sqrt((d ** 2).mean())

    assert err(mg) <= max(err(cg25), 1e-6) * 1.05, (err(mg), err(cg25))
    # and the unweighted case stays an exact Poisson solve round trip
    mg_u = np.asarray(pu.phase_unwrap_mg(jnp.asarray(psi), None))
    d = mg_u - psi0
    assert np.abs(d - d.mean()).max() < 1e-6
