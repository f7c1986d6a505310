"""Accelerator-mirror module (the cuGPA counterpart).

The reference ships a CuPy mirror of the lock-in / WFR path
(/root/reference/pyGPA/cuGPA.py) that users inject into the pipeline
through the wfr_func plugin seam (tests/test_cuGPA.py:49). Here the
whole framework is already device-native, so these are thin aliases
with cuGPA's exact names and signatures — including the
single-precision variant — letting cuGPA users switch by changing one
import. Results come back as jax Arrays (use np.asarray to match
cuGPA's .get() host copies).
"""
import jax.numpy as jnp

from .ops.lockin import gpa_lockin
from .gpa.api import _wgrid
from .ops.wfr import wfr_sweep


def tpuGPA(image, kvec, sigma=22):
    """Spatial lock-in; mirror of cuGPA.cuGPA (cuGPA.py:11-38)."""
    return gpa_lockin(image, jnp.asarray(kvec), sigma)


# the reference names the module function after the backend
cuGPA = tpuGPA


def wfr2_grad_opt(image, sigma, kx, ky, kw, kstep, grad=None):
    """WFR sweep with phase gradients; mirror of cuGPA.wfr2_grad_opt
    (cuGPA.py:41-87)."""
    return wfr_sweep(image, _wgrid(kx, ky, kw, kstep), (kx, ky), sigma,
                     with_grad=True)


def wfr2_grad_single(image, sigma, kx, ky, kw, kstep, grad=None):
    """Single-precision WFR sweep; mirror of cuGPA.wfr2_grad_single
    (cuGPA.py:90-133). Forces float32 regardless of x64 mode."""
    image = jnp.asarray(image, jnp.float32)
    g = wfr_sweep(image, _wgrid(kx, ky, kw, kstep).astype("float32"),
                  (kx, ky), sigma, with_grad=True)
    return {"lockin": g["lockin"], "grad": g["grad"]}


def wfr2_only_lockin(image, sigma, kvec, kw, kstep):
    """Lock-in-only sweep; mirror of cuGPA.wfr2_only_lockin
    (cuGPA.py:136-158). Note cuGPA's kvec-tuple signature."""
    kx, ky = kvec
    return wfr_sweep(image, _wgrid(kx, ky, kw, kstep), (kx, ky), sigma,
                     with_w=False)["lockin"]


def wfr2_only_grad(image, sigma, kvec, kw, kstep, grad=None):
    """Gradient-only sweep; mirror of cuGPA.wfr2_only_grad
    (cuGPA.py:161-202)."""
    kx, ky = kvec
    return wfr_sweep(image, _wgrid(kx, ky, kw, kstep), (kx, ky), sigma,
                     with_grad=True, with_w=False)["grad"]
