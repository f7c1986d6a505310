"""Weighted 2D phase unwrapping (Ghiglia-Romero) as an XLA solver.

Preconditioned conjugate gradient on the weighted Poisson equation,
with the unweighted-Poisson preconditioner solved by DCT — exactly the
algorithm of /root/reference/pyGPA/phase_unwrap.py (HOT LOOP #3 of the
pipeline), re-expressed for XLA:

 - the CG iteration is a single lax.while_loop (data-dependent stop on
   ||r|| < 1e-9 ||r0|| or k >= kmax), jit-compiled;
 - the DCT-II/inverse pair runs as one complex FFT per axis
   (core.fourier), so each CG step is 4 FFTs + fused stencils;
 - everything is batched/vmappable (used stacked over the two
   displacement components and over image stacks).

Reference: Ghiglia & Romero, JOSA A 11, 107 (1994).
"""
from functools import partial

import jax
import jax.numpy as jnp

import jax.lax

from ..config import DEFAULTS
from ..core.fourier import dct2n, idct2n
from ..core.mathtools import wrap_to_pi


def _poisson_scale(shape, dtype):
    """DCT-II eigenvalues of the Neumann 5-point Laplacian, with the
    [0,0] bias entry set to 1 (phase_unwrap.py:106-115). Note the
    reference divides index i (length N) by M and vice versa — a no-op
    for the square images it is used on; here each axis uses its own
    length."""
    n, m = shape
    i = jnp.arange(n, dtype=dtype)[:, None]
    j = jnp.arange(m, dtype=dtype)[None, :]
    scale = 2.0 * (jnp.cos(jnp.pi * i / n) + jnp.cos(jnp.pi * j / m) - 2.0)
    return scale.at[0, 0].set(1.0)


def solve_poisson(rho, scale=None):
    """Solve the Neumann Poisson equation P phi = rho via DCT
    (phase_unwrap.py:81-103)."""
    rho = jnp.asarray(rho)
    if scale is None:
        scale = _poisson_scale(rho.shape[-2:], rho.dtype)
    return idct2n(dct2n(rho) / scale)


def _apply_q(p, WWx, WWy):
    """Weighted transformation (A^T)(W^T W)(A) p (phase_unwrap.py:118-132)."""
    dx = jnp.diff(p, axis=-1)
    dy = jnp.diff(p, axis=-2)
    WWdx = WWx * dx
    WWdy = WWy * dy
    WWdx2 = jnp.diff(WWdx, axis=-1, prepend=0.0, append=0.0)
    WWdy2 = jnp.diff(WWdy, axis=-2, prepend=0.0, append=0.0)
    return WWdx2 + WWdy2


# --- aligned stencil forms -----------------------------------------------
# The reference formulation carries (n, m-1)/(n-1, m) difference arrays.
# The multigrid path instead keeps every plane (n, m) with a
# structurally-ZERO last column (x-diffs) / row (y-diffs): every
# elementwise pass then works on one shape, neighbor shifts become
# rotations (jnp.roll) and the zero tails make the wrap-around terms
# vanish, so the arithmetic is
# IDENTICAL to the reference stencils (phase_unwrap.py:118-175) entry
# for entry. Under GSPMD sharding the rolls lower to halo
# collective-permutes, so the distributed path shares these forms.

_JACOBI_OMEGA = 0.8   # damped-Jacobi factor (2D optimum 4/5)

def _mask_last(a, axis):
    """Zero the last slice along `axis` (fused iota compare)."""
    ax = axis % a.ndim
    idx = jax.lax.broadcasted_iota(jnp.int32, a.shape, ax)
    return jnp.where(idx < a.shape[ax] - 1, a, jnp.zeros((), a.dtype))


def _pad_last(a, axis):
    """Append one zero slice along `axis` ((n, m-1) -> aligned (n, m))."""
    shape = list(a.shape)
    shape[axis % a.ndim] = 1
    return jnp.concatenate([a, jnp.zeros(shape, a.dtype)], axis=axis)


def _residual_aligned(dxp, dyp, weight):
    """_residual on aligned planes: dxp/dyp are (..., n, m) with a zero
    last column/row. Returns rk and aligned WWx/WWy (zero tails)."""
    if weight is None:
        WWx = _mask_last(jnp.ones_like(dxp), -1)
        WWy = _mask_last(jnp.ones_like(dyp), -2)
    else:
        WW = weight * weight
        # WW >= 0, so masking before the min is equivalent and lets the
        # rolled wrap-around slot hold anything
        WWx = _mask_last(jnp.minimum(WW, jnp.roll(WW, -1, axis=-1)), -1)
        WWy = _mask_last(jnp.minimum(WW, jnp.roll(WW, -1, axis=-2)), -2)
    WWdx = WWx * dxp
    WWdy = WWy * dyp
    # zero tails make roll's wrap-around term vanish: this IS the
    # prepend/append diff of the reference residual
    rk = (WWdx - jnp.roll(WWdx, 1, axis=-1)
          + WWdy - jnp.roll(WWdy, 1, axis=-2))
    return rk, WWx, WWy


def _apply_q_aligned(p, WWx, WWy):
    """_apply_q with aligned (zero-tail) weights; the masked weights
    kill the wrap-around column/row of both rolls."""
    WWdx = WWx * (jnp.roll(p, -1, axis=-1) - p)
    WWdy = WWy * (jnp.roll(p, -1, axis=-2) - p)
    return (WWdx - jnp.roll(WWdx, 1, axis=-1)
            + WWdy - jnp.roll(WWdy, 1, axis=-2))


def _jacobi_dinv_aligned(WWx, WWy, omega=_JACOBI_OMEGA):
    """_jacobi_dinv from aligned weights (see _jacobi_dinv)."""
    D = -(WWx + jnp.roll(WWx, 1, axis=-1)
          + WWy + jnp.roll(WWy, 1, axis=-2))
    return jnp.where(jnp.abs(D) > 1e-8,
                     omega / jnp.where(D != 0, D, 1.0), 0.0)


def _cg_unwrap(rk0, WWx, WWy, kmax, precond=None, aligned=False):
    """PCG loop shared by phase_unwrap and phase_unwrap_prediff
    (phase_unwrap.py:183-207,326-349).

    `precond` overrides the unweighted-Poisson DCT preconditioner
    (a callable rk -> zk, hashable/static) — used by the row-sharded
    distributed solver (parallel/unwrap.py) to substitute the pencil
    all_to_all DCT."""
    return _cg_unwrap_jit(rk0, WWx, WWy, int(kmax), precond, aligned)


@partial(jax.jit, static_argnames=("kmax", "precond", "aligned"))
def _cg_unwrap_jit(rk0, WWx, WWy, kmax, precond=None, aligned=False):
    return _cg_unwrap_body(rk0, WWx, WWy, kmax, precond, aligned)


def _cg_unwrap_body(rk0, WWx, WWy, kmax, precond=None, aligned=False):
    dt = rk0.dtype
    scale = _poisson_scale(rk0.shape[-2:], dt)
    if precond is None:
        def precond(rk):
            return idct2n(dct2n(rk) / scale)
    # the reference's 1e-9 relative residual is unreachable in float32;
    # stop at a dtype-meaningful tolerance instead (f64 keeps 1e-9)
    eps = jnp.asarray(1e-9 if dt == jnp.float64 else 1e-6, dt)
    norm_r0 = jnp.linalg.norm(rk0)

    def cond(state):
        phi, rk, pk, rzprev, k, done = state
        return jnp.logical_not(done)

    def body(state):
        phi, rk, pk, rzprev, k, done = state
        zk = precond(rk)
        rz = jnp.vdot(rk, zk).real.astype(dt)
        # guarded Fletcher-Reeves / step coefficients: at (near-)exact
        # convergence rz and <p, Qp> underflow to 0 in f32; 0/0 would
        # poison the field with NaNs where the reference (f64) simply
        # never gets this far
        beta = jnp.where(rzprev != 0, rz / jnp.where(rzprev != 0,
                                                     rzprev, 1.0), 0.0)
        pk = jnp.where(k == 0, zk, zk + beta * pk)
        Qpk = (_apply_q_aligned if aligned else _apply_q)(pk, WWx, WWy)
        pq = jnp.vdot(pk, Qpk).real.astype(dt)
        alpha = jnp.where(pq != 0, rz / jnp.where(pq != 0, pq, 1.0), 0.0)
        phi = phi + alpha * pk
        rk = rk - alpha * Qpk
        k = k + 1
        done = ((k >= kmax) | (jnp.linalg.norm(rk) < eps * norm_r0)
                | (rz == 0))
        return phi, rk, pk, rz, k, done

    state = (jnp.zeros_like(rk0), rk0, jnp.zeros_like(rk0),
             jnp.ones((), dt), jnp.zeros((), jnp.int32),
             jnp.all(rk0 == 0.0))
    phi, rk, _, _, k, _ = jax.lax.while_loop(cond, body, state)
    return phi, k


def _residual(dx, dy, weight):
    """Build WWx, WWy and the initial residual from wrapped phase diffs
    (phase_unwrap.py:154-175: eq. 34 min-neighbor weighting)."""
    if weight is None:
        WWx = jnp.ones_like(dx)
        WWy = jnp.ones_like(dy)
        WWdx, WWdy = dx, dy
    else:
        WW = weight * weight
        WWx = jnp.minimum(WW[..., :, :-1], WW[..., :, 1:])
        WWy = jnp.minimum(WW[..., :-1, :], WW[..., 1:, :])
        WWdx = WWx * dx
        WWdy = WWy * dy
    rk = (jnp.diff(WWdx, axis=-1, prepend=0.0, append=0.0)
          + jnp.diff(WWdy, axis=-2, prepend=0.0, append=0.0))
    return rk, WWx, WWy


def phase_unwrap(psi, weight=None, kmax=DEFAULTS.unwrap_kmax,
                 return_iters=False):
    """Unwrap the phase image `psi` given `weight`.

    Drop-in for pyGPA.phase_unwrap.phase_unwrap (phase_unwrap.py:
    141-208): canonically psi is the angle and weight the magnitude of
    a complex lock-in signal. kmax bounds the CG iterations (static for
    jit). Batched over leading axes. With return_iters=True also
    returns the CG iteration count as a value (the device-side
    replacement of the reference's debug print at phase_unwrap.py:77).
    """
    psi = jnp.asarray(psi)
    dx = wrap_to_pi(jnp.diff(psi, axis=-1))
    dy = wrap_to_pi(jnp.diff(psi, axis=-2))
    rk, WWx, WWy = _residual(dx, dy, weight)
    phi, k = _cg_unwrap(rk, WWx, WWy, int(kmax))
    return (phi, k) if return_iters else phi


def phase_unwrap_mg(psi, weight=None, kmax=10, coarse=4, **kw):
    """Multigrid-accelerated phase_unwrap: wrapped-difference the phase
    image and integrate with the V-cycle solver the production pipeline
    uses (phase_unwrap_prediff_mg). Same task as phase_unwrap
    (phase_unwrap.py:141-208) solved by a different algorithm: on
    lock-in-weighted GPA phases the weighted Poisson system is badly
    conditioned and plain PCG converges slowly — on the 2048^2
    benchmark fixture this path lands ~7x closer to the converged
    solution than 25 CG iterations (max err 0.12 vs 0.89 rad against a
    200-iteration reference) at a fraction of their transforms. Prefer
    it whenever
    the phase is band-limited (every lock-in output is); phase_unwrap
    remains the reference-exact CG solver."""
    psi = jnp.asarray(psi)
    dx = jnp.diff(psi, axis=-1)
    dy = jnp.diff(psi, axis=-2)
    if weight is None:
        # unweighted unwrap IS one exact Poisson solve (CG with the
        # unweighted-Poisson preconditioner converges in one step) —
        # skip the V-cycle entirely
        rk, _, _ = _residual(wrap_to_pi(dx), wrap_to_pi(dy), None)
        return solve_poisson(rk)
    return phase_unwrap_prediff_mg(dx, dy, weight, kmax=int(kmax),
                                   coarse=coarse, **kw)


def phase_unwrap_prediff(dx, dy, weight=None,
                         kmax=DEFAULTS.unwrap_kmax,
                         return_iters=False):
    """Unwrap from phase gradients dx = diff(psi, axis=-1) (N, M-1) and
    dy = diff(psi, axis=-2) (N-1, M). Drop-in for
    pyGPA.phase_unwrap.phase_unwrap_prediff (phase_unwrap.py:282-350);
    used to integrate displacement gradients in reconstruction
    (geometric_phase_analysis.py:239-242)."""
    dx = wrap_to_pi(jnp.asarray(dx))
    dy = wrap_to_pi(jnp.asarray(dy))
    rk, WWx, WWy = _residual(dx, dy, weight)
    phi, k = _cg_unwrap(rk, WWx, WWy, int(kmax))
    return (phi, k) if return_iters else phi



def _avg_right(m_in, cols, c, dtype):
    """(m_in, cols) right-multiplication block-averaging matrix,
    built in-graph from iotas (a multi-MB numpy literal would be
    embedded in the executable and stall XLA's constant pipeline)."""
    i = jnp.arange(m_in, dtype=jnp.int32)[:, None]
    j = jnp.arange(cols, dtype=jnp.int32)[None, :]
    return jnp.where(i // c == j, jnp.asarray(1.0 / c, dtype),
                     jnp.zeros((), dtype))


def _resize_right(m_in, m_out, dtype):
    """(m_in, m_out) right-multiplication linear-interpolation matrix
    reproducing jax.image.resize(method='linear') along one axis
    (half-pixel centers, edge clamp); built in-graph from iotas."""
    scale = m_in / m_out
    pos = (jnp.arange(m_out, dtype=dtype) + 0.5) * scale - 0.5
    lo = jnp.clip(jnp.floor(pos), 0, m_in - 1)
    hi = jnp.clip(lo + 1, 0, m_in - 1)
    t = jnp.clip(pos - lo, 0.0, 1.0)
    i = jnp.arange(m_in, dtype=dtype)[:, None]
    return ((i == lo[None, :]) * (1.0 - t)[None, :]
            + (i == hi[None, :]) * t[None, :]).astype(dtype)


def _sep2(a, left, right):
    """left @ a @ right over the last two axes as two einsums —
    separable resampling without gathers or lane-splitting reshapes.
    HIGHEST: with TF32 (Precision.HIGH/DEFAULT on an H100) the
    multigrid's restriction/prolongation moved the 4096^2 deformed
    bench gate to 0.102 px (> 0.075)."""
    hi = jax.lax.Precision.HIGHEST
    if left is not None:
        a = jnp.einsum("rn,...nm->...rm", left, a, precision=hi)
    if right is not None:
        a = jnp.einsum("...nm,mc->...nc", a, right, precision=hi)
    return a


def _jacobi_dinv(rk, WWx, WWy, omega=_JACOBI_OMEGA):
    """omega / diag(Q) for damped-Jacobi smoothing. The diagonal of
    _apply_q at (i, j) is -(WWx[i,j-1] + WWx[i,j] + WWy[i-1,j] +
    WWy[i,j]) (zero-padded at the borders). Rim pixels carry ~1e-12
    weights — gate them to 0 and leave the rim to the coarse solve."""
    zx = jnp.zeros_like(rk[..., :, :1])
    zy = jnp.zeros_like(rk[..., :1, :])
    D = -(jnp.concatenate([WWx, zx], axis=-1)
          + jnp.concatenate([zx, WWx], axis=-1)
          + jnp.concatenate([WWy, zy], axis=-2)
          + jnp.concatenate([zy, WWy], axis=-2))
    return jnp.where(jnp.abs(D) > 1e-8,
                     omega / jnp.where(D != 0, D, 1.0), 0.0)


def phase_unwrap_prediff_mg(dx, dy, weight=None, kmax=10, coarse=4,
                            refine_iters=3,
                            schedule=None, precond_factory=None,
                            v_coarse_mult=4):
    """Multigrid-accelerated gradient integration: solve the weighted
    Poisson problem on a coarse grid (GPA displacement gradients are
    band-limited by the sigma-wide lock-in window), then walk a
    V-cycle of progressively finer levels, each polishing the
    upsampled solution with a few CG iterations on the residual
    gradients. Full-resolution DCT rounds — the pipeline's single
    largest cost at 4096^2 — are reduced to the final level's iters.

    schedule : ((factor, iters), ...) coarsest -> finest; iters="v"
    on a refinement level runs the smooth/coarse-correct/smooth
    V-branch instead of CG (see inline comment). The default
    is ((coarse, kmax), (coarse//2, 2), (1, 1)) for coarse >= 4 and
    ((coarse, kmax), (1, refine_iters)) otherwise. The exact reference
    algorithm remains phase_unwrap_prediff; end-to-end accuracy of
    this path is gated by the reference displacement tolerances in
    tests/test_pipeline.py (test_factory_multigrid_accuracy).
    """
    dx = wrap_to_pi(jnp.asarray(dx))
    dy = wrap_to_pi(jnp.asarray(dy))
    n = dx.shape[-2]
    m = dy.shape[-1]
    if schedule is None:
        c = int(coarse)
        if c >= 4:
            # one mid-level CG iteration matches two to 1e-4 px on the
            # reference fixtures (CPU float64: deconv err 0.0298 vs
            # 0.0299, noisy 0.8529 vs 0.8517); the final full-res CG
            # step's line search does the real smooth-defect fix.
            # (Damped-Jacobi or alpha=1 Richardson finals were tried
            # and FAIL the gates — the coarse levels' block-averaged
            # weights leave smooth defect only the preconditioned
            # line-search step removes.) The mid level is skipped on
            # large images (DEFAULTS.unwrap_mg_mid="auto", mid grid
            # >= 1024 px): the V-branch finest level revisits a
            # coarse grid anyway; small images keep it (see
            # config.py).
            mid_cfg = DEFAULTS.unwrap_mg_mid
            if mid_cfg == "auto":
                mid_iters = 0 if min(n, m) // (c // 2) >= 1024 else 1
            else:
                mid_iters = int(mid_cfg)
            mid = ((c // 2, mid_iters),) if mid_iters else ()
            schedule = ((c, int(kmax)),) + mid \
                + ((1, DEFAULTS.unwrap_mg_final),)
        else:
            schedule = ((c, int(kmax)), (1, int(refine_iters)))

    dt = dx.dtype
    # aligned planes: every level's x/y-diffs live in (rows, cols)
    # arrays with a structurally-zero last column/row (see the
    # aligned stencil forms above) — the only odd-width arrays in
    # the whole solve are the user-facing inputs, padded once here
    dxp = _pad_last(dx, -1) if dx.shape[-1] == m - 1 else dx
    dyp = _pad_last(dy, -2) if dy.shape[-2] == n - 1 else dy

    def block_mean(a, rows, cols, c):
        # last (column) axis as a matmul against a block-averaging
        # matrix; the row axis by plain reshape-mean (a row-side
        # matmul would contract the FINE length). Under GSPMD the row
        # reshape stays row-sharded when rows*c divides evenly per
        # device (the meshes used keep power-of-two rows).
        a = a[..., : rows * c, : cols * c]
        a = a.reshape(a.shape[:-2] + (rows, c, cols * c)).mean(-2)
        R = _avg_right(cols * c, cols, c, dt)
        return _sep2(a, None, R)

    def level_data(c):
        if c == 1:
            return dxp, dyp, weight
        nc, mc = n // c, m // c
        # coarse differences = c * block-averaged fine differences; one
        # stacked einsum pair restricts both planes (no re-wrapping:
        # they can legitimately exceed pi). The last coarse column/row
        # mixes real and pad values — masked back to the structural
        # zero (the reference coarse problem has no diff there).
        dxyc = block_mean(jnp.stack([dxp, dyp], 0), nc, mc, c) * c
        dxc = _mask_last(dxyc[0], -1)
        dyc = _mask_last(dxyc[1], -2)
        wc = block_mean(weight, nc, mc, c) if weight is not None \
            else None
        return dxc, dyc, wc

    def upsample(phi, nc, mc):
        rin = phi.shape[-2]
        if nc % rin == 0 and nc // rin > 1:
            # integer-factor row upsample as a shifted-plane
            # interleave: out[c*i + j] = (1-t_j) phi[lo] + t_j phi[lo+1]
            # with the half-pixel offsets o_j = (j+.5)/c - .5 — exactly
            # _resize_right's samples (edge rows clamp, where both taps
            # coincide): elementwise work instead of a row-side
            # interpolation matmul over the fine length.
            cfac = nc // rin
            prev = jnp.concatenate([phi[..., :1, :], phi[..., :-1, :]],
                                   axis=-2)
            nxt = jnp.concatenate([phi[..., 1:, :], phi[..., -1:, :]],
                                  axis=-2)
            pieces = []
            for j in range(cfac):
                o = (j + 0.5) / cfac - 0.5
                if o < 0:
                    t = jnp.asarray(1.0 + o, dt)
                    pj = (1 - t) * prev + t * phi
                else:
                    t = jnp.asarray(o, dt)
                    pj = (1 - t) * phi + t * nxt
                pieces.append(pj)
            up = jnp.stack(pieces, axis=-2)
            phi = up.reshape(phi.shape[:-2]
                             + (rin * cfac, phi.shape[-1]))
        elif rin != nc:
            phi = _sep2(phi, _resize_right(rin, nc, dt).T, None)
        R = _resize_right(phi.shape[-1], mc, dt) \
            if phi.shape[-1] != mc else None
        return _sep2(phi, None, R)

    phi = None
    for c, iters in schedule:
        dxc, dyc, wc = level_data(int(c))
        nc, mc = n // int(c), m // int(c)
        pre = precond_factory((nc, mc)) if precond_factory else None
        if phi is None:
            rk, WWx, WWy = _residual_aligned(dxc, dyc, wc)
            phi, _ = _cg_unwrap(rk, WWx, WWy, int(iters), pre,
                                aligned=True)
            continue
        phi = upsample(phi, nc, mc)
        if isinstance(iters, str):
            if iters not in ("v", "vv"):
                raise ValueError(
                    f"schedule iters must be an int, 'v' or 'vv' "
                    f"(got {iters!r}); check DEFAULTS.unwrap_mg_final")
            # fine-level V-branch: damped-Jacobi pre-smooth -> coarse-
            # grid correction of the smoothed residual with an EXACT
            # energy line search (alpha = <r,p>/<p,Qp> absorbs the
            # restriction scaling) -> damped-Jacobi post-smooth.
            # Replaces the full-resolution DCT-preconditioned CG step
            # with stencil passes + a coarse
            # CG solve; Jacobi alone FAILS here (the coarse levels'
            # block-averaged weights leave a smooth defect), the
            # coarse revisit is what fixes it. "vv" runs a second
            # correct+smooth round on the updated residual.
            rounds = 2 if iters == "vv" else 1
            cv = int(v_coarse_mult) * int(c)
            rdx = dxc - _mask_last(jnp.roll(phi, -1, axis=-1)
                                   - phi, -1)
            rdy = dyc - _mask_last(jnp.roll(phi, -1, axis=-2)
                                   - phi, -2)
            rk, WWx, WWy = _residual_aligned(rdx, rdy, wc)
            Dinv = _jacobi_dinv_aligned(WWx, WWy)
            d = rk * Dinv
            r = rk - _apply_q_aligned(d, WWx, WWy)

            dxv, dyv, wv = level_data(cv)
            _, WWxv, WWyv = _residual_aligned(dxv, dyv, wv)
            prev = precond_factory((n // cv, m // cv)) \
                if precond_factory else None
            # coarse-correction CG depth: DEFAULTS.unwrap_mg_v_kmax
            vk = int(kmax) if DEFAULTS.unwrap_mg_v_kmax is None \
                else int(DEFAULTS.unwrap_mg_v_kmax)
            for j in range(rounds):
                r2c = block_mean(r, n // cv, m // cv, cv)
                dcor, _ = _cg_unwrap(r2c, WWxv, WWyv, vk, prev,
                                     aligned=True)
                dcu = upsample(dcor, nc, mc)
                q = _apply_q_aligned(dcu, WWx, WWy)
                num = jnp.vdot(r, dcu).real.astype(dt)
                den = jnp.vdot(dcu, q).real.astype(dt)
                alpha = jnp.where(
                    den != 0, num / jnp.where(den != 0, den, 1.0), 0.0)
                d = d + alpha * dcu
                r = r - alpha * q
                s = r * Dinv
                d = d + s
                if j < rounds - 1:
                    r = r - _apply_q_aligned(s, WWx, WWy)
            phi = phi + d
            continue
        # residual gradients are small and unwrapped by construction
        rdx = dxc - _mask_last(jnp.roll(phi, -1, axis=-1) - phi, -1)
        rdy = dyc - _mask_last(jnp.roll(phi, -1, axis=-2) - phi, -2)
        if iters > 0:
            rk, WWx, WWy = _residual_aligned(rdx, rdy, wc)
            dphi, _ = _cg_unwrap(rk, WWx, WWy, int(iters), pre,
                                 aligned=True)
            phi = phi + dphi
    if int(schedule[-1][0]) != 1:
        phi = upsample(phi, n, m)
    return phi


# --- pyGPA.phase_unwrap API-parity surface -------------------------------
# The reference exposes non-precomputed "reference implementations" and
# the solver internals (phase_unwrap.py:26-138); here the optimized
# and reference paths are the same compiled program.

def _wrapToPi(x):
    """(phase_unwrap.py:135-138)."""
    return wrap_to_pi(x)


def phase_unwrap_ref(psi, weight=None, kmax=DEFAULTS.unwrap_kmax):
    """Non-precomputed reference variant (phase_unwrap.py:26-78) —
    same solver here."""
    return phase_unwrap(psi, weight, kmax)


def phase_unwrap_ref_prediff(dx, dy, weight=None,
                             kmax=DEFAULTS.unwrap_kmax):
    """(phase_unwrap.py:211-279) — same solver here."""
    return phase_unwrap_prediff(dx, dy, weight, kmax)


def solvePoisson(rho):
    """(phase_unwrap.py:81-92)."""
    return solve_poisson(rho)


def precomp_Poissonscaling(rho):
    """(phase_unwrap.py:106-115)."""
    rho = jnp.asarray(rho)
    return _poisson_scale(rho.shape[-2:], rho.dtype)


def solvePoisson_precomped(rho, scale):
    """(phase_unwrap.py:95-103)."""
    return idct2n(dct2n(jnp.asarray(rho)) / scale)


def applyQ(p, WWx, WWy):
    """(phase_unwrap.py:118-132)."""
    return _apply_q(jnp.asarray(p), jnp.asarray(WWx), jnp.asarray(WWy))
