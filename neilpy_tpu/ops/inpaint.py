"""NaN inpainting as matrix-free jit-compiled linear solves.

Reference: neilpy/neilpy.py:1171-1283 — D'Errico-style inpainting via
sparse least squares (``lsqr``) over (a) a 4-neighbour "spring" graph
(method 4, the one used by ``create_dem`` and ``smrf``) and (b) a
second-difference operator (method 0/1).

Design
------
Both systems have symmetric positive (semi-)definite normal equations
whose operators are local stencils on the grid:

* springs: ``(L x)_p = deg(p) * x_p - sum_{q ~ p, q unknown} x_q`` with
  ``deg`` = number of in-bounds 4-neighbours; RHS = sum of known
  neighbour values.  This graph Laplacian's least-squares equilibrium
  is exactly what lsqr converges to, so a matrix-free conjugate-gradient
  solve with a Jacobi preconditioner reproduces it without ever
  building a sparse matrix — every apply is four shifts and adds that
  XLA fuses, and the whole solve jits onto the device (and shards with a
  1-px halo exchange).

* fda: normal operator ``D^T D`` of the stacked row/column
  second-difference operator, again applied matrix-free with pad/slice
  stencils.  Rows whose support contains no NaN contribute constants
  and drop out of the minimisation, which is why this matches the
  reference's ``fast=True`` row restriction (neilpy.py:1196-1200).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = ["inpaint_nans_by_springs", "inpaint_nans_by_fda",
           "inpaint_nearest", "inpaint_nearest_device", "cg_solve",
           "springs_fill"]


def _neighbor_sum(X, mask):
    """Sum of in-bounds 4-neighbour values of X (masked by ``mask`` at
    the *source*), plus the in-bounds neighbour count."""
    H, W = X.shape
    z = jnp.zeros((1, W), dtype=X.dtype)
    zc = jnp.zeros((H, 1), dtype=X.dtype)
    mz = jnp.zeros((1, W), dtype=mask.dtype)
    mzc = jnp.zeros((H, 1), dtype=mask.dtype)
    Xm = X * mask
    up = jnp.concatenate([Xm[1:], z], axis=0)
    dn = jnp.concatenate([z, Xm[:-1]], axis=0)
    lf = jnp.concatenate([Xm[:, 1:], zc], axis=1)
    rt = jnp.concatenate([zc, Xm[:, :-1]], axis=1)
    s = up + dn + lf + rt
    mu = jnp.concatenate([mask[1:], mz], axis=0)
    md = jnp.concatenate([mz, mask[:-1]], axis=0)
    ml = jnp.concatenate([mask[:, 1:], mzc], axis=1)
    mr = jnp.concatenate([mzc, mask[:, :-1]], axis=1)
    return s, mu + md + ml + mr


def _degree(shape, dtype=jnp.float32):
    """Number of in-bounds 4-neighbours per cell (4 interior, 3 edge,
    2 corner)."""
    H, W = shape
    rows = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    deg = ((rows > 0).astype(dtype) + (rows < H - 1).astype(dtype)
           + (cols > 0).astype(dtype) + (cols < W - 1).astype(dtype))
    return deg


def cg_solve(apply_fn, b, x0, precond=None, tol=1e-7, maxiter=2000,
             flexible=False):
    """Conjugate gradients with optional preconditioner, expressed as a
    ``lax.while_loop`` so the whole solve stays on device.  ``apply_fn``
    must be linear, symmetric, positive definite on the masked
    subspace.  ``flexible=True`` uses the Polak–Ribière beta
    (Notay's flexible CG), which stays robust when the preconditioner
    is only approximately symmetric — e.g. a multigrid V-cycle."""
    b = jnp.asarray(b)
    if precond is None:
        precond = lambda r: r
    bnorm = jnp.sqrt(jnp.sum(b * b))
    atol2 = (tol * jnp.maximum(bnorm, 1e-30)) ** 2

    r0 = b - apply_fn(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(state):
        x, r, p, rz, it = state
        return (jnp.sum(r * r) > atol2) & (it < maxiter)

    def body(state):
        x, r, p, rz, it = state
        Ap = apply_fn(p)
        alpha = rz / jnp.sum(p * Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = jnp.sum(r_new * z)
        if flexible:
            beta = (rz_new - jnp.sum(r * z)) / rz
        else:
            beta = rz_new / rz
        p = z + beta * p
        return x, r_new, p, rz_new, it + 1

    x, r, _, _, it = lax.while_loop(cond, body,
                                    (x0, r0, p0, rz0, jnp.int32(0)))
    return x, it


def springs_fill(A, tol=1e-7, maxiter=4000, multiscale=True):
    """Traceable spring-graph fill (no jit wrapper): compose freely
    inside larger jitted pipelines (e.g. the fused SMRF raster stage).
    Returns the filled array only."""
    out, _ = _springs_core(A, tol, maxiter, multiscale)
    return out


def _blocksum2(X):
    """2x2 block sum (restriction = prolongationᵀ for the piecewise-
    constant interpolation used by the multigrid cycle)."""
    H, W = X.shape
    Hp, Wp = -(-H // 2) * 2, -(-W // 2) * 2
    P = jnp.zeros((Hp, Wp), dtype=X.dtype).at[:H, :W].set(X)
    return P.reshape(Hp // 2, 2, Wp // 2, 2).sum(axis=(1, 3))


def _prolong2(Xc, H, W):
    """Piecewise-constant 2x prolongation cropped to (H, W)."""
    return jnp.repeat(jnp.repeat(Xc, 2, axis=0), 2, axis=1)[:H, :W]


def _pad_even(X):
    H, W = X.shape
    return jnp.pad(X, ((0, H % 2), (0, W % 2)))


def _build_levels(unknown, deg, min_size=4):
    """Exact Galerkin coarse hierarchy of the masked spring Laplacian
    under piecewise-constant transfers (aggregation multigrid).

    Each level is ``(diag, E, S, u)`` coefficient arrays: ``diag`` the
    diagonal, ``E[r, c]`` the (positive) coupling weight to the east
    neighbour ``(r, c+1)``, ``S`` the coupling to the south neighbour,
    ``u`` the unknown mask.  Because the fine operator is 5-point and
    the transfers are 2x2 block-constant, the Galerkin product RAP
    stays exactly 5-point at every level: diagonally adjacent blocks
    share no fine edges.  The recursion is pure edge counting —

    * inter-block coupling = sum of fine edge weights crossing the
      block boundary,
    * block diagonal = sum of fine diagonals − 2 × (intra-block edge
      weight sum),

    so every level's operator is *the* variational coarse operator (no
    geometric rescaling heuristics), which is what makes the cycle a
    proper SPD preconditioner.
    """
    u = unknown
    diag = deg * u
    E = jnp.pad(u[:, :-1] * u[:, 1:], ((0, 0), (0, 1)))
    S = jnp.pad(u[:-1, :] * u[1:, :], ((0, 1), (0, 0)))
    levels = [(diag, E, S, u)]
    while min(u.shape) > min_size:
        level = _coarsen_level(*levels[-1])
        levels.append(level)
        u = level[3]
    return levels


def _coarsen_level(diag, E, S, u):
    """One Galerkin coarsening step ``(diag, E, S, u) -> coarse level``
    (see ``_build_levels``); odd extents are zero-padded first."""
    diag, E, S, u = map(_pad_even, (diag, E, S, u))
    H, W = diag.shape

    def blk(X):
        return X.reshape(H // 2, 2, W // 2, 2)

    # an E-edge with left endpoint at even column is intra-block;
    # at odd column it crosses into the east block (same for S/rows)
    intra_h = blk(E)[:, :, :, 0].sum(axis=1)
    E_c = blk(E)[:, :, :, 1].sum(axis=1)
    intra_v = blk(S)[:, 0, :, :].sum(axis=2)
    S_c = blk(S)[:, 1, :, :].sum(axis=2)
    diag_c = blk(diag).sum(axis=(1, 3)) - 2.0 * (intra_h + intra_v)
    u_c = (blk(u).sum(axis=(1, 3)) > 0).astype(u.dtype)
    return diag_c, E_c, S_c, u_c


def _apply_level(x, diag, E, S):
    """Apply the 5-point coefficient-array operator of one level."""
    xe = jnp.pad(x[:, 1:], ((0, 0), (0, 1)))
    xw = jnp.pad(x[:, :-1], ((0, 0), (1, 0)))
    Ew = jnp.pad(E[:, :-1], ((0, 0), (1, 0)))
    xs = jnp.pad(x[1:, :], ((0, 1), (0, 0)))
    xn = jnp.pad(x[:-1, :], ((1, 0), (0, 0)))
    Sn = jnp.pad(S[:-1, :], ((1, 0), (0, 0)))
    return diag * x - E * xe - Ew * xw - S * xs - Sn * xn


def _coarse_cg(r, level, iters=24):
    """Fixed-iteration CG solve of the coarsest level (a few hundred
    unknowns at most) — accurate enough that the coarsest solve never
    caps cycle quality, with guards so a zero residual stays zero."""
    diag, E, S, u = level

    def A(x):
        return _apply_level(x * u, diag, E, S) * u

    def body(i, st):
        x, rr, p, rz = st
        Ap = A(p)
        pAp = jnp.sum(p * Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp > 0, pAp, 1.0), 0.0)
        x = x + alpha * p
        rn = rr - alpha * Ap
        rzn = jnp.sum(rn * rn)
        beta = jnp.where(rz > 0, rzn / jnp.where(rz > 0, rz, 1.0), 0.0)
        return x, rn, rn + beta * p, rzn

    zero = jnp.zeros_like(r)
    x, _, _, _ = lax.fori_loop(0, iters, body,
                               (zero, r, r, jnp.sum(r * r)))
    return x


def _kcycle(r, levels, l, omega=0.9, nsmooth=2, kdepth=2,
            coarse_iters=24):
    """One multigrid K-cycle on the Galerkin hierarchy, used as the
    flexible-CG preconditioner.

    Damped-Jacobi (ω=0.9) pre/post smoothing; at the first ``kdepth``
    level transitions the coarse problem is solved with TWO steps of
    flexible CG preconditioned by the next level's cycle (Notay's
    K-cycle) instead of a single recursive call — the standard fix for
    the per-level rate degradation of piecewise-constant (unsmoothed
    aggregation) transfers.  Below that depth plain V-recursion keeps
    the traced program small.  Measured on 30%-contiguous-NaN fills:
    9–14 outer CG iterations from 96×128 to 2048², vs 65–133 for the
    round-2 geometric-scaled V(2,2) cycle.

    Smoothing chains run as ``lax.fori_loop``s: letting XLA:CPU fuse a
    chain of concatenate-based stencil applies makes it *recompute*
    fused producers per consumer (~17x per-smooth slowdown measured at
    1024^2); the loop boundary keeps each smooth a single pass.
    """
    if l + 1 == len(levels):
        return _coarse_cg(r, levels[l], iters=coarse_iters)

    diag, E, S, u = levels[l]
    H, W = u.shape
    invD = jnp.where(diag > 0, omega / diag, 0.0) * u

    def A(x):
        return _apply_level(x * u, diag, E, S) * u

    def smooth(_, x):
        return x + invD * (r - A(x))

    x = lax.fori_loop(0, nsmooth, smooth, jnp.zeros_like(r))
    rc = _blocksum2(r - A(x)) * levels[l + 1][3]

    if kdepth > 0 and l + 2 < len(levels):
        dc, Ec, Sc, uc = levels[l + 1]

        def Ac(xx):
            return _apply_level(xx * uc, dc, Ec, Sc) * uc

        def _safe(num, den):
            return jnp.where(den != 0, num / jnp.where(den != 0, den, 1.0),
                             0.0)

        xc = jnp.zeros_like(rc)
        rr = rc
        z = _kcycle(rr, levels, l + 1, omega, nsmooth, kdepth - 1,
                    coarse_iters)
        p = z
        rz = jnp.sum(rr * z)
        for _ in range(2):
            Ap = Ac(p)
            alpha = _safe(rz, jnp.sum(p * Ap))
            xc = xc + alpha * p
            r_new = rr - alpha * Ap
            z_new = _kcycle(r_new, levels, l + 1, omega, nsmooth,
                            kdepth - 1, coarse_iters)
            rz_new = jnp.sum(r_new * z_new)
            beta = _safe(rz_new - jnp.sum(rr * z_new), rz)
            p = z_new + beta * p
            rr, z, rz = r_new, z_new, rz_new
    else:
        xc = _kcycle(rc, levels, l + 1, omega, nsmooth, 0, coarse_iters)

    x = x + _prolong2(xc, H, W) * u
    return lax.fori_loop(0, nsmooth, smooth, x)


def _springs_core(A, tol, maxiter, multiscale=True):
    A = jnp.asarray(A)
    if A.dtype not in (jnp.float32, jnp.float64):
        A = A.astype(jnp.float32)  # f64 preserved for the exact path
    nanmask = jnp.isnan(A)
    unknown = nanmask.astype(A.dtype)
    known_vals = jnp.where(nanmask, 0.0, A)
    known_mask = 1.0 - unknown

    deg = _degree(A.shape, dtype=A.dtype)

    def apply_fn(x):
        # x lives on the unknown cells (zero elsewhere)
        x = x * unknown
        s, _ = _neighbor_sum(x, unknown)
        return (deg * x - s) * unknown

    b, _ = _neighbor_sum(known_vals, known_mask)
    b = b * unknown

    # warm start: mean of known values (flat sheet)
    mean = jnp.nansum(known_vals) / jnp.maximum(jnp.sum(known_mask), 1.0)
    x0 = unknown * mean

    H, W = A.shape
    if multiscale and min(H, W) >= 64:
        # multigrid-preconditioned flexible CG: a Galerkin K-cycle
        # bounds the preconditioned condition number independent of the
        # NaN-region diameter, so iteration counts stay ~O(10) from
        # 64^2 to mosaic scale (plain Jacobi-CG needs O(diameter)
        # iterations per residual decade).
        levels = _build_levels(unknown, deg)
        precond = lambda r: _kcycle(r, levels, 0)
        x, it = cg_solve(apply_fn, b, x0, precond=precond, tol=tol,
                         maxiter=maxiter, flexible=True)
    else:
        inv_deg = jnp.where(deg > 0, 1.0 / deg, 0.0)
        precond = lambda r: r * inv_deg * unknown
        x, it = cg_solve(apply_fn, b, x0, precond=precond, tol=tol,
                         maxiter=maxiter)
    return jnp.where(nanmask, x, A), it


def _warn_exhausted(it, maxiter, tol):
    if int(it) >= int(maxiter):
        import warnings
        warnings.warn(
            f"inpaint_nans_by_springs: CG exhausted maxiter={maxiter} "
            f"without reaching tol={tol}; result is the best iterate. "
            "Raise maxiter or loosen tol.", RuntimeWarning)


@partial(jax.jit, static_argnames=("tol", "maxiter", "multiscale"))
def _springs_solve(A, tol=1e-7, maxiter=4000, multiscale=True):
    out, it = _springs_core(A, tol, maxiter, multiscale)
    # async host callback: warns on exhaustion without forcing the
    # caller to block on the solve (an eager int(it) here would
    # serialize every pipeline that dispatches the fill asynchronously)
    jax.debug.callback(partial(_warn_exhausted, maxiter=maxiter, tol=tol),
                       it)
    return out, it


def inpaint_nans_by_springs(A, inplace=False, neighbors=4, tol=1e-7,
                            maxiter=4000, multiscale=True,
                            return_info=False):
    """Spring-graph inpainting (parity: neilpy.py:1227-1271).

    Matrix-free CG on the spring normal equations; equilibrium matches
    the reference's lsqr solution to solver tolerance.  ``multiscale``
    preconditions the (flexible) CG solve with a Galerkin multigrid
    K-cycle (same equilibrium, ~O(10) iterations regardless of the
    NaN-region diameter).  ``return_info=True`` additionally returns
    ``{"iterations", "converged", "maxiter"}``; a solve that exhausts
    ``maxiter`` warns either way.
    """
    if neighbors != 4:
        raise ValueError("At the moment, only 4 neighbors are supported.")
    del inplace  # functional API: always returns the filled array
    out, it = _springs_solve(jnp.asarray(A), tol=tol, maxiter=maxiter,
                             multiscale=multiscale)
    if return_info:
        it = int(it)
        return out, {"iterations": it, "converged": it < maxiter,
                     "maxiter": maxiter}
    # the async callback warns on exhaustion: no host sync on this path
    return out


def _second_diff_apply(x, unknown):
    """Apply D^T D where D stacks all interior row/column second
    differences (the fda operator, neilpy.py:1180-1194)."""
    H, W = x.shape
    x = x * unknown

    # column-direction second differences: t[r] = x[r-1] - 2x[r] + x[r+1]
    tv = x[:-2, :] - 2.0 * x[1:-1, :] + x[2:, :]
    # D_v^T t scatters t with the same stencil
    yv = jnp.zeros_like(x)
    yv = yv.at[:-2, :].add(tv)
    yv = yv.at[1:-1, :].add(-2.0 * tv)
    yv = yv.at[2:, :].add(tv)

    th = x[:, :-2] - 2.0 * x[:, 1:-1] + x[:, 2:]
    yh = jnp.zeros_like(x)
    yh = yh.at[:, :-2].add(th)
    yh = yh.at[:, 1:-1].add(-2.0 * th)
    yh = yh.at[:, 2:].add(th)

    return (yv + yh) * unknown


@partial(jax.jit, static_argnames=("tol", "maxiter"))
def _fda_solve(A, tol=1e-7, maxiter=8000):
    A = jnp.asarray(A, dtype=jnp.float32)
    nanmask = jnp.isnan(A)
    unknown = nanmask.astype(jnp.float32)
    known_vals = jnp.where(nanmask, 0.0, A)

    def apply_fn(x):
        return _second_diff_apply(x, unknown)

    # b = -D^T D applied to the known values, restricted to unknowns
    b = -_second_diff_apply_known(known_vals, unknown)

    mean = jnp.nansum(known_vals) / jnp.maximum(jnp.sum(1.0 - unknown), 1.0)
    x0 = unknown * mean
    x, it = cg_solve(apply_fn, b, x0, tol=tol, maxiter=maxiter)
    return jnp.where(nanmask, x, A), it


def _second_diff_apply_known(k, unknown):
    """(D^T D k)|unknown where k carries the known values (zeros at
    unknowns): the cross term of the normal equations."""
    tv = k[:-2, :] - 2.0 * k[1:-1, :] + k[2:, :]
    yv = jnp.zeros_like(k)
    yv = yv.at[:-2, :].add(tv)
    yv = yv.at[1:-1, :].add(-2.0 * tv)
    yv = yv.at[2:, :].add(tv)
    th = k[:, :-2] - 2.0 * k[:, 1:-1] + k[:, 2:]
    yh = jnp.zeros_like(k)
    yh = yh.at[:, :-2].add(th)
    yh = yh.at[:, 1:-1].add(-2.0 * th)
    yh = yh.at[:, 2:].add(th)
    return (yv + yh) * unknown


def inpaint_nans_by_fda(A, fast=True, inplace=False, tol=1e-7,
                        maxiter=8000):
    """Second-difference (biharmonic-flavoured) inpainting (parity:
    neilpy.py:1171-1216).  ``fast`` is accepted for API parity; the
    matrix-free formulation already drops constant rows, which is what
    fast=True's row restriction achieves."""
    del fast, inplace
    out, _ = _fda_solve(A, tol=tol, maxiter=maxiter)
    return out


def inpaint_nearest(X):
    """Nearest-finite-value fill (parity: neilpy.py:1277-1283).

    Host path via scipy's KD-tree interpolator — exact Euclidean
    nearest with the reference's index-order tie-breaking.  For
    device-resident pipelines use ``inpaint_nearest_device`` (a
    jump-flooding fill that jits and shards).
    """
    X = np.asarray(X, dtype=np.float64)
    from scipy import interpolate
    idx = np.isfinite(X)
    RI, CI = np.meshgrid(np.arange(X.shape[0]), np.arange(X.shape[1]))
    f_near = interpolate.NearestNDInterpolator(
        (RI.T[idx], CI.T[idx]), X[idx])
    miss = ~idx
    X[miss] = f_near(RI.T[miss], CI.T[miss])
    return X


@jax.jit
def inpaint_nearest_device(X):
    """Nearest-finite-value fill as a jump-flooding pass on device.

    Each cell carries (seed row, seed col, seed value); rounds of
    8-neighbour propagation at power-of-two offsets (N/2, N/4, ..., 1)
    keep the closest seed by squared Euclidean distance.  Runs fully
    under jit (log2(N) rounds of static shifts).  JFA can differ from
    the exact KD-tree fill on tie/near-tie cells (both are *a* nearest
    finite value); tested to agree with scipy on distance.
    """
    X = jnp.asarray(X, dtype=jnp.float32)
    H, W = X.shape
    finite = jnp.isfinite(X)
    rows = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    BIG = jnp.int32(2 ** 30)
    sr = jnp.where(finite, rows, BIG)
    sc = jnp.where(finite, cols, BIG)
    sv = jnp.where(finite, X, 0.0)

    def shift(a, dy, dx, fill):
        return jnp.roll(jnp.where(_inb(rows, cols, dy, dx, H, W),
                                  a, fill), (dy, dx), axis=(0, 1))

    def _d2(r, c):
        dr = (r - rows).astype(jnp.float32)
        dc = (c - cols).astype(jnp.float32)
        return dr * dr + dc * dc

    step = 1 << max(int(np.ceil(np.log2(max(H, W, 2)))) - 1, 0)
    state = (sr, sc, sv)
    while step >= 1:
        r0, c0, v0 = state
        best_d = _d2(r0, c0)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                rn = shift(r0, dy, dx, BIG)
                cn = shift(c0, dy, dx, BIG)
                vn = shift(v0, dy, dx, 0.0)
                dn = _d2(rn, cn)
                take = dn < best_d
                r0 = jnp.where(take, rn, r0)
                c0 = jnp.where(take, cn, c0)
                v0 = jnp.where(take, vn, v0)
                best_d = jnp.where(take, dn, best_d)
        state = (r0, c0, v0)
        step //= 2
    r0, c0, v0 = state
    return jnp.where(finite, X, v0)


def _inb(rows, cols, dy, dx, H, W):
    """Mask of source cells whose roll destination stays in bounds
    (prevents wraparound seeds)."""
    # destination (r+dy, c+dx) in bounds <=> source read guard after roll
    return ((rows + dy >= 0) & (rows + dy < H)
            & (cols + dx >= 0) & (cols + dx < W))
