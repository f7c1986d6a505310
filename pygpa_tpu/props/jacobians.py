"""Per-pixel Jacobian algebra: J = grad(u) fields -> local lattice
properties (twist angle, anisotropy direction/magnitude, scale,
heterostrain).

Reference behavior: /root/reference/pyGPA/property_extract.py:13-578.
Implementation notes:
 - every np.linalg.svd over (N, M, 2, 2) fields is replaced by a
   closed-form, fully vectorized 2x2 SVD (svd2x2) that returns the
   same symmetric-Householder left factor LAPACK produces, so the
   reference's sign-fixing algebra (property_extract.py:163-178) is
   reproduced exactly without any LAPACK calls;
 - the per-pixel weighted lstsq uses solvers.lstsq (closed form);
 - everything is jit-compatible and batched over leading axes.
"""
import jax
import jax.numpy as jnp

from ..config import DEFAULTS
from ..core.mathtools import (wrap_to_pi, periodic_average,
                              periodic_difference, standardize_ks)
from ..solvers.lstsq import weighted_lstsq_stack
from ..gpa.kgeometry import calc_diff_from_isotropic, f2angle
from ..lattices.generate import generate_ks
from ..ops.wfr import _np_gradient_2d


def svd2x2_planes(a, b, c, d):
    """Closed-form 2x2 SVD on separate component planes
    (a=A00, b=A01, c=A10, d=A11). Returns
    ((u00,u01,u10,u11), (s0,s1), (v00,v01,v10,v11)) — all elementwise
    arrays: big property fields stay in plane layout end to end (a
    trailing (..., 2, 2) layout makes every elementwise pass work on
    2-element minor dimensions)."""
    E = (a + d) * 0.5
    F = (a - d) * 0.5
    G = (c + b) * 0.5
    H = (c - b) * 0.5
    Q = jnp.hypot(E, H)
    R = jnp.hypot(F, G)
    sx = Q + R
    det = a * d - b * c
    sy = jnp.where(sx > 0, det / jnp.where(sx > 0, sx, 1.0), 0.0)
    a1 = jnp.arctan2(G, F)
    a2 = jnp.arctan2(H, E)
    theta_u = (a2 + a1) * 0.5
    theta_v = (a1 - a2) * 0.5
    cu, su = jnp.cos(theta_u), jnp.sin(theta_u)
    cv, sv = jnp.cos(theta_v), jnp.sin(theta_v)
    sgn = jnp.where(sy < 0, -1.0, 1.0).astype(sx.dtype)
    u = (cu, su, su, -cu)
    vh = (cv, sv, sgn * sv, -sgn * cv)
    return u, (sx, jnp.abs(sy)), vh


def _props_core(a, b, c, d, refangle=0.0, refscale=1.0, diff=False,
                phys=False, poisson_ratio=DEFAULTS.poisson_ratio):
    """Shared plane-based property decomposition
    (property_extract.py:137-217): the sign-fixed SVD algebra on
    component planes."""
    (u00, u01, u10, u11), (s0, s1), (v00, v01, v10, v11) = \
        svd2x2_planes(a, b, c, d)
    # signs = sign(diag(u)); v <- column-scaled; u <- (signs*u)^T
    g0 = jnp.sign(u00)
    g1 = jnp.sign(u11)
    w00, w01 = g0 * v00, g1 * v01
    w10, w11 = g0 * v10, g1 * v11
    t00, t01 = g0 * u00, g0 * u10   # transposed, column-scaled u
    t10, t11 = g1 * u01, g1 * u11
    # u_p = (u_new @ v_new)^T ; need [0,0] and [1,0] of u_p
    up00 = t00 * w00 + t01 * w10
    up10 = t00 * w01 + t01 * w11   # (u@v)[0,1] -> transposed [1,0]
    angle = jnp.rad2deg(jnp.arctan2(up10, up00))
    aniangle = jnp.rad2deg(jnp.arctan2(t10, t00))
    if phys:
        delta = poisson_ratio
        fourth = (s0 - s1) / (s0 + delta * s1)
        if diff:
            aniangle = aniangle + 90
            alpha = s0 / (1 + fourth)
        else:
            alpha = s1 * (1 + fourth)
    else:
        fourth = s0 / s1
        if diff:
            aniangle = aniangle + 90
            alpha = s0
        else:
            alpha = s1
    aniangle = aniangle % 180
    return jnp.stack(jnp.broadcast_arrays(angle + refangle, aniangle,
                                          alpha * refscale, fourth))


def props_from_planes(J00, J01, J10, J11, refangle=0.0, refscale=1.0,
                      diff=False, decomposition=None,
                      poisson_ratio=DEFAULTS.poisson_ratio, jac=False):
    """props_from_Jac on component planes — the layout big fields
    use. With jac=False the planes are J (I is added here)."""
    eye = 0.0 if jac else 1.0
    return _props_core(J00 + eye, J01, J10, J11 + eye,
                       refangle=refangle, refscale=refscale, diff=diff,
                       phys=(decomposition == "physical"),
                       poisson_ratio=poisson_ratio)


def svd2x2(A):
    """Closed-form SVD of a (..., 2, 2) stack.

    Returns (u, s, vh) with s descending and u in the symmetric
    Householder form [[c, s], [s, -c]] — the convention
    numpy.linalg.svd (LAPACK) produces for generic 2x2 inputs, on
    which the props_from_Jac sign-fixing relies. Fully elementwise:
    fused device passes instead of host LAPACK loops.
    """
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 1, 0]
    d = A[..., 1, 1]
    E = (a + d) * 0.5
    F = (a - d) * 0.5
    G = (c + b) * 0.5
    H = (c - b) * 0.5
    Q = jnp.hypot(E, H)
    R = jnp.hypot(F, G)
    sx = Q + R
    # small singular value via the determinant (stable where Q ~ R,
    # i.e. extreme anisotropy — the dlasv2 trick), signed by det
    det = a * d - b * c
    sy = jnp.where(sx > 0, det / jnp.where(sx > 0, sx, 1.0), 0.0)
    a1 = jnp.arctan2(G, F)
    a2 = jnp.arctan2(H, E)
    theta_u = (a2 + a1) * 0.5   # left rotation angle
    theta_v = (a1 - a2) * 0.5   # right rotation angle
    cu, su = jnp.cos(theta_u), jnp.sin(theta_u)
    cv, sv = jnp.cos(theta_v), jnp.sin(theta_v)
    # Householder left factor: R(theta_u) @ diag(1, -1)
    u = jnp.stack([jnp.stack([cu, su], -1),
                   jnp.stack([su, -cu], -1)], -2)
    # A = u @ diag(sx, |sy|) @ vh with the sy sign absorbed in vh row 2
    sgn = jnp.where(sy < 0, -1.0, 1.0).astype(A.dtype)
    # R(theta_v)^T rows: (cv, sv), (-sv, cv)
    vh = jnp.stack([jnp.stack([cv, sv], -1),
                    jnp.stack([sgn * sv, -sgn * cv], -1)], -2)
    s = jnp.stack([sx, jnp.abs(sy)], -1)
    return u, s, vh


def props_from_Jac(Jac, refangle=0.0, refscale=1.0, diff=False):
    """Local lattice properties from a (stack of) 2x2 Jacobian(s)
    (property_extract.py:137-178).

    Returns [angle (deg), anisotropy angle (deg, mod 180),
    scale alpha, anisotropy kappa] stacked on a new leading axis.
    Internally unpacks to component planes immediately.
    """
    Jac = jnp.asarray(Jac)
    return _props_core(Jac[..., 0, 0], Jac[..., 0, 1],
                       Jac[..., 1, 0], Jac[..., 1, 1],
                       refangle=refangle, refscale=refscale, diff=diff)


def phys_props_from_Jac(Jac, refangle=0.0, refscale=1.0, diff=False,
                        poisson_ratio=DEFAULTS.poisson_ratio):
    """Physical (heterostrain) decomposition
    (property_extract.py:181-217). Returns
    [angle, strain angle, alpha, epsilon]."""
    Jac = jnp.asarray(Jac)
    return _props_core(Jac[..., 0, 0], Jac[..., 0, 1],
                       Jac[..., 1, 0], Jac[..., 1, 1],
                       refangle=refangle, refscale=refscale, diff=diff,
                       phys=True, poisson_ratio=poisson_ratio)


def props_from_J(J, refangle=0.0, refscale=1.0):
    """props_from_Jac of J + I (property_extract.py:220-221)."""
    return props_from_Jac(jnp.asarray(J) + jnp.eye(2),
                          refangle=refangle, refscale=refscale)


def props_from_J_old(J):
    """Legacy decomposition (property_extract.py:224-231)."""
    u, s, v = svd2x2(jnp.asarray(J))
    angle = u @ v
    moireangle = jnp.rad2deg(jnp.arctan2(angle[..., 1, 0], angle[..., 0, 0]))
    aniangle = jnp.rad2deg(jnp.arctan2(v[..., 1, 0], v[..., 0, 0])) % 180
    return [moireangle, aniangle, jnp.sqrt(s[..., 0] * s[..., 1]),
            s[..., 0] / s[..., 1]]


def u2J_planes(U, nmperpixel):
    """u2J in component-plane layout: returns (J00, J01, J10, J11)
    with J[c, d] = d(-U_c)/d(x_d) / nmperpixel."""
    U = jnp.asarray(U)
    gx, gy = _np_gradient_2d(-U)
    return (gx[0] / nmperpixel, gy[0] / nmperpixel,
            gx[1] / nmperpixel, gy[1] / nmperpixel)


def props_from_u(U, nmperpixel, refangle=0.0, refscale=1.0, diff=False,
                 decomposition=None):
    """Local properties directly from a displacement field, entirely in
    plane layout (no (N, M, 2, 2) materialization)."""
    J00, J01, J10, J11 = u2J_planes(U, nmperpixel)
    return props_from_planes(J00, J01, J10, J11, refangle=refangle,
                             refscale=refscale, diff=diff,
                             decomposition=decomposition)


def u2J(U, nmperpixel):
    """J (= -grad u) field from a displacement field (2, N, M)
    (property_extract.py:13-19). For large fields prefer u2J_planes /
    props_from_u (layout note there)."""
    U = jnp.asarray(U)
    gx, gy = _np_gradient_2d(-U)
    J = jnp.stack([gx, gy], axis=-1) / nmperpixel
    return jnp.moveaxis(J, 0, -2)


def u2Jac(U, nmperpixel):
    """I + u2J. (The reference's u2Jac, property_extract.py:21-26,
    drops nmperpixel when calling u2J — a latent TypeError; fixed
    here.)"""
    return jnp.eye(2) + u2J(U, nmperpixel)


def phases2J(kvecs, phases, weights, nmperpixel):
    """J from (wrapped) phases via per-pixel gradients
    (property_extract.py:39-52)."""
    kvecs = jnp.asarray(kvecs)
    phases = jnp.asarray(phases)
    K = 2 * jnp.pi * kvecs
    gx, gy = _np_gradient_2d(phases)
    dbdx = wrap_to_pi(gx * 2) / 2 / nmperpixel
    dbdy = wrap_to_pi(gy * 2) / 2 / nmperpixel
    dudx = weighted_lstsq_stack(dbdx, K, weights)
    dudy = weighted_lstsq_stack(dbdy, K, weights)
    J = -jnp.stack([dudx, dudy], axis=-1)
    return jnp.moveaxis(J, 0, -2)


def phases2Jac(kvecs, phases, weights, nmperpixel):
    """I + phases2J (property_extract.py:29-37)."""
    return jnp.eye(2) + phases2J(kvecs, phases, weights, nmperpixel)


def phasegradient2J(kvecs, grads, weights, nmperpixel, iso_ref=True,
                    sort=0):
    """J directly from the WFR per-pixel phase gradients
    (property_extract.py:69-101): rebases the gradients to the
    isotropic reference lattice (calc_diff_from_isotropic) before the
    per-pixel lstsq, countering reference-vector boundary artefacts."""
    kvecs = jnp.asarray(kvecs)
    grads = jnp.asarray(grads)
    angles = jnp.arctan2(kvecs[:, 1], kvecs[:, 0])
    if sort == 0:
        lkvecs = kvecs
        order = jnp.arange(kvecs.shape[0])
    else:
        order = jnp.argsort(sort * periodic_difference(
            angles, periodic_average(angles)))
        lkvecs = kvecs[order]
    if iso_ref:
        dks = calc_diff_from_isotropic(lkvecs)
        K = 2 * jnp.pi * (lkvecs + dks)
        iso_grads = grads[order] - 2 * jnp.pi * dks[:, None, None, :]
        iso_grads = wrap_to_pi(iso_grads)
    else:
        K = 2 * jnp.pi * kvecs
        iso_grads = grads
    dudx = weighted_lstsq_stack(iso_grads[..., 0], K, weights)
    dudy = weighted_lstsq_stack(iso_grads[..., 1], K, weights)
    J = jnp.stack([dudx, dudy], axis=-1) / nmperpixel
    return jnp.moveaxis(J, 0, -2)


def phasegradient2Jac(kvecs, grads, weights, nmperpixel):
    """I + phasegradient2J (property_extract.py:55-66)."""
    return jnp.eye(2) + phasegradient2J(kvecs, grads, weights, nmperpixel)


def get_initial_props(ks, standardize=False):
    """Mean magnitude, reference angle (snapped to the hexagonal sector
    of the first k), and symmetry of a k-vector set
    (property_extract.py:491-503)."""
    if standardize:
        kvecs = jnp.asarray(standardize_ks(ks))
    else:
        kvecs = jnp.asarray(ks)
    symmetry = 2 * kvecs.shape[0]
    r_k = jnp.linalg.norm(kvecs, axis=1).mean()
    theta_0 = jnp.rad2deg(periodic_average(
        jnp.arctan2(kvecs[:, 1], kvecs[:, 0]), 2 * jnp.pi / symmetry))
    hexa = jnp.arange(-180, 180, 60)
    first_angle = jnp.rad2deg(jnp.arctan2(kvecs[0, 1], kvecs[0, 0]))
    diffind = jnp.argmin(jnp.abs(theta_0 + hexa - first_angle))
    return r_k, theta_0 + hexa[diffind], symmetry


def get_ref_prop_dict(ks):
    """(property_extract.py:506-508)."""
    r_k, theta_0, _ = get_initial_props(ks)
    return {"refangle": theta_0, "refscale": r_k}


def kvecs2J(ks, standardize=True):
    """J mapping the isotropic reference lattice onto `ks`
    (property_extract.py:104-129)."""
    if standardize:
        kvecs = jnp.asarray(standardize_ks(ks))
    else:
        kvecs = jnp.asarray(ks)
    r_k, theta_0, symmetry = get_initial_props(kvecs)
    krefs = generate_ks(r_k, theta_0, sym=symmetry)[:3]
    if standardize:
        krefs = jnp.asarray(standardize_ks(krefs))
    dks = krefs - kvecs
    J = jnp.linalg.lstsq(krefs, -dks)[0]
    return J.T


def kvecs2Jac(ks, standardize=True):
    """(property_extract.py:131-134)."""
    return kvecs2J(ks, standardize=standardize) + jnp.eye(2)


def J_2_J_diff(J, theta_iso):
    """Map a moire J to the layer-difference J via J0(theta_iso)
    (property_extract.py:302-309)."""
    t = jnp.deg2rad(theta_iso)
    J0 = jnp.array([[jnp.cos(t) - 1, -jnp.sin(t)],
                    [jnp.sin(t), jnp.cos(t) - 1]])
    return jnp.matmul(J, J0, precision=jax.lax.Precision.HIGHEST)


def Jac_2_Jac_diff(Jac, theta_iso):
    """(property_extract.py:296-299)."""
    return jnp.eye(2) + J_2_J_diff(jnp.asarray(Jac) - jnp.eye(2), theta_iso)


def u_moire_2_u_diff(u, theta_iso):
    """(property_extract.py:312-318)."""
    t = jnp.deg2rad(theta_iso)
    J0 = jnp.array([[jnp.cos(t) - 1, -jnp.sin(t)],
                    [jnp.sin(t), jnp.cos(t) - 1]])
    return jnp.matmul(jnp.asarray(u), J0,
                      precision=jax.lax.Precision.HIGHEST)


def Jac_diff_from_phasegradient(kvecs, grads, weights, nmperpixel,
                                a_0=DEFAULTS.a_0):
    """(property_extract.py:321-331)."""
    J = phasegradient2J(kvecs, grads, weights, nmperpixel)
    r_k, theta_0, symmetry = get_initial_props(kvecs)
    theta_iso = f2angle(r_k, nmperpixel=nmperpixel, a_0=a_0)
    return jnp.eye(2) + J_2_J_diff(J, theta_iso)


def calc_props_from_phasegradient(kvecs, grads, weights, nmperpixel):
    """Properties from WFR phase gradients (property_extract.py:234-255)."""
    Jac = phasegradient2Jac(kvecs, grads, weights, nmperpixel)
    r_k, theta_0, symmetry = get_initial_props(kvecs)
    props = props_from_Jac(Jac)
    return props.at[0].add(theta_0)


def calc_props_from_phases(kvecs, phases, weights, nmperpixel):
    """Properties from wrapped phases (property_extract.py:258-278)."""
    Jac = phases2Jac(kvecs, phases, weights, nmperpixel)
    r_k, theta_0, symmetry = get_initial_props(kvecs)
    props = props_from_Jac(Jac)
    return props.at[0].add(theta_0)


def calc_eps_from_phasegradient(kvecs, grads, weights, nmperpixel):
    """Local lower-bound heterostrain (property_extract.py:281-293)."""
    Jac_diff = Jac_diff_from_phasegradient(kvecs, grads, weights,
                                           nmperpixel)
    props = props_from_Jac(Jac_diff)
    kappa = props[3]
    delta = DEFAULTS.poisson_ratio
    return (kappa - 1) / (1 + delta * kappa)


def calc_props_from_phasegradient2(kvecs, grads, weights, nmperpixel,
                                   a_0=DEFAULTS.a_0):
    """Uniaxial-strain properties from phase gradients
    (property_extract.py:334-356)."""
    kvecs = jnp.asarray(kvecs)
    dks = calc_diff_from_isotropic(kvecs)
    theta_iso = f2angle(jnp.linalg.norm(kvecs + dks, axis=1),
                        nmperpixel=nmperpixel).mean()
    xi_iso = (jnp.rad2deg(jnp.arctan2((kvecs + dks)[..., 1],
                                      (kvecs + dks)[..., 0])) % 60).mean()
    J = phasegradient2J(kvecs, grads, weights, nmperpixel)
    J_diff = J_2_J_diff(J, theta_iso)
    props = props_from_J(J_diff)
    props = props.at[2].multiply(theta_iso)
    return props.at[0].add(xi_iso)


def calc_props_from_kvecs4(ks, decomposition=None, standardize=False):
    """Lattice properties directly from ks
    (property_extract.py:359-392)."""
    Jac = kvecs2Jac(ks, standardize=standardize)
    r_k, theta_0, symmetry = get_initial_props(ks, standardize=standardize)
    if decomposition == "physical":
        props = phys_props_from_Jac(Jac, diff=True)
    else:
        props = props_from_Jac(Jac, diff=True)
    props = props.at[0].add(theta_0)
    return props.at[2].multiply(r_k)


def moire_props_from_Jac(kvecs, Jac, nmperpixel, a_0=DEFAULTS.a_0,
                         decomposition=None):
    """(property_extract.py:442-454)."""
    r_k, theta_0, symmetry = get_initial_props(kvecs)
    theta_iso = f2angle(r_k, nmperpixel=nmperpixel, a_0=a_0)
    Jac_moire = Jac_2_Jac_diff(Jac, theta_iso)
    if decomposition == "physical":
        props = phys_props_from_Jac(Jac_moire)
    else:
        props = props_from_Jac(Jac_moire)
    props = props.at[0].add(theta_iso)
    return props.at[1].add(-theta_iso / 2)


def calc_moire_props_from_kvecs(ks, nmperpixel=3.7, a_0=DEFAULTS.a_0,
                                decomposition="physical"):
    """(property_extract.py:395-419)."""
    Jac = kvecs2Jac(ks, standardize=False)
    return moire_props_from_Jac(jnp.asarray(ks), Jac, nmperpixel, a_0,
                                decomposition)


def moire_props_from_phasegradient(kvecs, grads, weights, nmperpixel,
                                   a_0=DEFAULTS.a_0, decomposition=None):
    """(property_extract.py:422-439)."""
    Jac = phasegradient2Jac(kvecs, grads, weights, nmperpixel)
    return moire_props_from_Jac(kvecs, Jac, nmperpixel, a_0, decomposition)


def twist_matrix(angle):
    """B(theta) = R(theta/2) - R(-theta/2), the k-space twist
    difference matrix (property_extract.py:457-479). angle in deg."""
    ha = jnp.deg2rad(angle / 2)
    c, s = jnp.cos(ha), jnp.sin(ha)
    return jnp.array([[c, -s], [s, c]]) - jnp.array([[c, s], [-s, c]])


def calc_abcd(J, delta=DEFAULTS.poisson_ratio):
    """Symmetric/antisymmetric decomposition of J
    (property_extract.py:511-520)."""
    a = (J[..., 0, 0] + J[..., 1, 1]) / (1 - delta)
    b = (J[..., 0, 1] + J[..., 1, 0]) / (1 + delta)
    c = (J[..., 1, 0] - J[..., 0, 1]) / (1 - delta)
    d = (J[..., 1, 1] - J[..., 0, 0]) / (1 + delta)
    return a, b, c, d


def double_strain_decomp(Jac, delta=DEFAULTS.poisson_ratio):
    """Analytical double-strain decomposition
    (property_extract.py:523-578; marked UNTESTED in the reference —
    ported as-is, without its debug prints).
    Returns [2*phi (deg), theta (deg), epsa, epsb]."""
    a, b, c, d = calc_abcd(Jac, delta=delta)
    bd = b * b + d * d
    alpha = 4 / (1 - delta)
    ca = c * c / (alpha * alpha)
    c0 = bd * (1 + ca * (1 - 2 * jnp.sqrt(bd) / alpha))
    c1 = -ca * (1 - 2 * jnp.sqrt(bd) / alpha)
    btemp = bd + a * a * (1 - c1)
    epsminus = jnp.sqrt(0.5 * (btemp + jnp.sqrt(btemp ** 2 + 4 * a * a * c0)))
    epsplussquare = c0
    for _ in range(2):
        epsplussquare = c0 + c1 * epsminus * epsminus
        epsminussquare = ((bd + a * a) + jnp.sqrt(
            (bd + a * a) ** 2 + a * a * epsplussquare)) / 2
        epsminus = jnp.sqrt(epsminussquare)
    epsplus = jnp.sqrt(epsplussquare)
    phi = jnp.arcsin(c / (alpha + epsplus))
    epsr = jnp.tan(phi) * epsminus / epsplus
    theta = 0.5 * jnp.arctan((b - d * epsr) / (b * epsr + d))
    epsa = 0.5 * (epsplus + epsminus)
    epsb = 0.5 * (epsplus - epsminus)
    return jnp.stack(jnp.broadcast_arrays(
        2 * jnp.rad2deg(phi), jnp.rad2deg(theta), epsa, epsb))
