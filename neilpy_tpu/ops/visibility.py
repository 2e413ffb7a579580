"""Openness, skyview factor, and geomorphon terrain classification.

This is the flagship compute path (reference call stack §3.2:
neilpy/neilpy.py:1325-1356 openness, 1360-1384 skyview_factor,
1404-1430 ternary_pattern_from_openness, 1600-1610 count_openness,
1617-1654 geomorphons, 1579-1596 geomorphons2).

Design
------
The reference computes, per direction d and scan distance L,
``angle = pi/2 - atan((ashift(Z,d,L) - Z) / (cellsize*L*w_d))`` and
keeps the per-direction *minimum* over L (16 x lookup_pixels full-array
passes, each with an atan).  Because atan is monotonic, the minimum
angle equals ``pi/2 - atan(max_L ratio_L)`` — so the whole ladder
collapses to a running max (and, for negative openness, a running min)
of the slope *ratios*, with a single atan per direction at the end.
That removes ~99% of the transcendentals and makes the scan a pure
shift/FMA/max pipeline: the XLA engine below, or the fused Pallas
kernel in ops/pallas_scan.py, which ``engine="auto"`` takes on the GPU
(``backend.resolve_engine``).

Boundary semantics: ``ashift`` leaves out-of-range positions at their
original value, so the reference's ladder implicitly contributes a
ratio of exactly 0 for every out-of-range L.  The scan reproduces this
with masked contributions.  NaN handling matches the reference's
"NaN never replaces the running min" comparison semantics.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from ..backend import resolve_engine
from ..core.shift import OFFSETS, STEP_LENGTH
from ..core.codes import (progressive_window, lowest_equivalent_table,
                          jasiewicz_stepinski_table)

__all__ = [
    "openness", "openness_pair", "skyview_factor", "count_openness",
    "geomorphons", "geomorphons2", "ternary_pattern_from_openness",
    "directional_ratio_extrema",
]


# ----------------------------------------------------------------------
# Core fused scan
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("lookup_pixels", "directions", "fast",
                                   "how_fast", "global_shape"))
def directional_ratio_extrema(Z, cellsize=1.0, lookup_pixels=1,
                              directions=tuple(range(8)), fast=False,
                              how_fast=20, origin=None, global_shape=None):
    """Running max/min of ``(Z[p + d*L] - Z[p]) / (cellsize * L * w_d)``
    over the scan ladder L, per direction.

    Returns (mx, mn, seen) each shaped (n_directions, H, W):
      * ``mx``  — max ratio (positive-openness horizon tangent)
      * ``mn``  — min ratio (drives negative openness: max of -ratio = -mn)
      * ``seen``— whether any contribution (valid or boundary-zero with a
        finite value) was recorded; False only where every ladder step
        hit NaN terrain, mirroring the reference's Inf-initialised min.

    Blocked structure (the same ladder as the Pallas kernel, in pure
    XLA, so every backend gets it): the raster
    is NaN-padded by the scan radius once, each ladder step reads one
    shifted slice of the padded constant (``lax.dynamic_slice``), NaN
    reads (padding or nodata holes) are skipped by compare-select, and
    the reference's edge-replication semantics (out-of-range step ->
    contribution exactly 0) are restored by one per-direction boundary
    epilogue (out-of-range is monotone in L, so testing the largest
    step covers the ladder).  This replaces the r2 scan that carried 8
    rolled copies plus a per-step iota validity mask — measured 3.4x
    on CPU and extrema bit-identical (same division, same skips).

    Sharded execution: pass ``origin`` (traced global row/col of local
    pixel (0,0)) and static ``global_shape`` so the boundary epilogue
    is evaluated in *global* coordinates — a halo-padded block then
    produces bit-identical extrema to the single-device kernel for
    every core pixel (used by dist.sharded_geomorphons); reads beyond
    block+halo land in the NaN pad and are skipped, exactly like the
    single-device raster edge.
    """
    Z = jnp.asarray(Z, dtype=jnp.float32)
    H, W = Z.shape
    dirs = tuple(directions)
    R = int(lookup_pixels)

    cellsize = jnp.float32(cellsize)
    neg_inf = jnp.float32(-jnp.inf)
    pos_inf = jnp.float32(jnp.inf)

    rows = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    if origin is not None:
        rows = rows + origin[0]
        cols = cols + origin[1]
    GH, GW = global_shape if global_shape is not None else (H, W)

    Zp = jnp.pad(Z, R, constant_values=jnp.nan)
    ladder = ([int(v) for v in progressive_window(1, R, how_fast)]
              if fast else None)
    Rmax = ladder[-1] if fast else R

    mxs, mns, seens = [], [], []
    for d in dirs:
        dr, dc = OFFSETS[d]
        w = jnp.float32(STEP_LENGTH[d])

        def contribute(mx_d, mn_d, src, Lf):
            ratio = (src - Z) / (cellsize * w * Lf)
            # compare-select skips NaN (padding / nodata holes)
            mx_d = jnp.where(ratio > mx_d, ratio, mx_d)
            mn_d = jnp.where(ratio < mn_d, ratio, mn_d)
            return mx_d, mn_d

        mx0 = jnp.full_like(Z, neg_inf)
        mn0 = jnp.full_like(Z, pos_inf)
        if fast:
            mx, mn = mx0, mn0
            for L in ladder:      # static slice offsets, unrolled
                src = lax.slice(Zp, (R + dr * L, R + dc * L),
                                (R + dr * L + H, R + dc * L + W))
                mx, mn = contribute(mx, mn, src, jnp.float32(L))
        else:
            def body(carry, L):
                mx_d, mn_d = carry
                src = lax.dynamic_slice(Zp, (R + dr * L, R + dc * L),
                                        (H, W))
                return contribute(mx_d, mn_d, src,
                                  L.astype(jnp.float32)), None

            Ls = jnp.arange(1, R + 1, dtype=jnp.int32)
            (mx, mn), _ = lax.scan(body, (mx0, mn0), Ls)

        # edge-replication epilogue: any out-of-range step contributes
        # ratio exactly 0 (ashift keeps original values out of range)
        sr = rows + dr * Rmax
        sc = cols + dc * Rmax
        oob = (sr < 0) | (sr >= GH) | (sc < 0) | (sc >= GW)
        mx = jnp.where(oob, jnp.maximum(mx, 0.0), mx)
        mn = jnp.where(oob, jnp.minimum(mn, 0.0), mn)
        mxs.append(mx)
        mns.append(mn)
        seens.append(mx > neg_inf)

    return jnp.stack(mxs), jnp.stack(mns), jnp.stack(seens)


def _angles_from_extrema(mx, seen):
    """Per-direction minimum zenith angle in radians: pi/2 - atan(mx),
    +inf where the ladder never saw a finite value."""
    ang = jnp.pi / 2 - jnp.arctan(mx)
    return jnp.where(seen, ang, jnp.inf)


# ----------------------------------------------------------------------
# Public surface
# ----------------------------------------------------------------------
def openness(Z, cellsize=1, lookup_pixels=1, neighbors=None, skyview=False,
             fast=False, how_fast=20, engine="auto"):
    """Yokoyama positive openness in degrees (neilpy.py:1325-1356).

    Mean over the requested directions of the minimum zenith angle along
    the scan ladder.  Negative openness = ``openness(-Z, ...)``.

    ``skyview`` is accepted for signature parity but ignored — exactly
    as in the reference, whose body never reads it (neilpy.py:1325);
    use ``skyview_factor`` for SVF.

    ``engine='auto'`` runs the ladder through the Pallas kernel on
    the GPU (same extrema as the XLA scan).
    """
    if neighbors is None:
        neighbors = range(8)
    dirs = tuple(int(d) for d in np.atleast_1d(np.asarray(neighbors)))
    engine = resolve_engine(engine)
    if engine == "pallas":
        if dirs == tuple(range(8)):
            # fused in-kernel reduction: 2 plane writes instead of 16;
            # atan runs in-kernel, within a few ulp of the XLA epilogue
            from .pallas_scan import openness_pallas
            pos, _ = openness_pallas(
                Z, cellsize=float(cellsize),
                lookup_pixels=int(lookup_pixels), fast=bool(fast),
                how_fast=int(how_fast))
            return pos
        from .pallas_scan import directional_extrema_pallas
        mx_all, _ = directional_extrema_pallas(
            Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
            fast=bool(fast), how_fast=int(how_fast))
        mx = mx_all[jnp.asarray(dirs)]
        seen = mx > -jnp.inf
    else:
        mx, _, seen = directional_ratio_extrema(
            Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
            directions=dirs, fast=fast, how_fast=how_fast)
    ang = _angles_from_extrema(mx, seen)
    return jnp.rad2deg(jnp.mean(ang, axis=0))


def openness_pair(Z, cellsize=1, lookup_pixels=1, fast=False,
                  how_fast=20, engine="auto"):
    """(positive, negative) openness from ONE ladder pass.

    ``openness(-Z)`` equals the negative openness derived from the same
    extrema (``mx(-Z) == -mn(Z)`` exactly: ratios negate, compare-select
    order preserves ties/NaN skips, and the oob epilogue's
    ``max(-mn, 0) == -min(mn, 0)``), so both planes come from a single
    scan — half the cost of the two-pass ``openness(Z)``/``openness(-Z)``
    pattern the reference uses (neilpy.py:1325-1356).  On the Pallas
    engine the reduction happens in-kernel (2 plane writes)."""
    engine = resolve_engine(engine)
    if engine == "pallas":
        from .pallas_scan import openness_pallas
        return openness_pallas(Z, cellsize=float(cellsize),
                               lookup_pixels=int(lookup_pixels),
                               fast=bool(fast), how_fast=int(how_fast))
    mx, mn, seen = directional_ratio_extrema(
        Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
        fast=fast, how_fast=how_fast)
    pos = jnp.rad2deg(jnp.mean(_angles_from_extrema(mx, seen), axis=0))
    neg = jnp.rad2deg(jnp.mean(_angles_from_extrema(-mn, seen), axis=0))
    return pos, neg


def skyview_factor(Z, cellsize=1, lookup_pixels=1, engine="auto"):
    """Skyview factor: 1 - mean(sin(max positive horizon angle))
    (neilpy.py:1360-1384).

    Reformulated onto the directional ratio-extrema kernel: the
    reference accumulates single-pixel ``ashift``s, so once a ray exits
    the raster the shifted value FREEZES at the ray's exit elevation
    while the distance keeps growing — every post-exit contribution
    ``(Z[exit] - Z[p]) / (w L)`` is therefore dominated either by the
    exit step itself (positive differences shrink with L) or by the 0
    floor (the reference initialises max_angles at 0).  Hence exactly

        SVF = 1 - mean_d sin(atan(max(mx_d, 0)))

    with ``mx_d`` the valid-step ratio maximum — the quantity the
    openness ladder already computes — and ``sin(atan(t)) =
    t/sqrt(1+t^2)``.  ``engine='pallas'`` (auto on the GPU) runs the
    fused kernel; 'xla' the blocked scan.  Both reproduce the reference
    loop's boundary quirk bit-for-bit at the max level (atan is
    monotone, so maxing ratios == maxing angles).
    """
    Z = jnp.asarray(Z, dtype=jnp.float32)
    engine = resolve_engine(engine)
    if engine == "pallas":
        # fused in-kernel reduction (1 plane write instead of 16);
        # sin(atan(t)) = t/sqrt(1+t^2) is algebraic, so the only
        # deviation from the XLA path is divide/sqrt rounding (~1 ulp)
        from .pallas_scan import skyview_pallas
        return skyview_pallas(Z, cellsize=float(cellsize),
                              lookup_pixels=int(lookup_pixels))
    mx, _, _ = directional_ratio_extrema(
        Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels))
    return svf_from_extrema(mx)


def svf_from_extrema(mx):
    """SVF from per-direction max ratios: 1 - mean sin(atan(max(t,0)))
    with sin(atan(t)) = t/sqrt(1+t^2); the clip at 0 also absorbs
    unseen rays (mx = -inf).  Shared by the single-device and sharded
    skyview paths."""
    t = jnp.maximum(mx, 0.0)
    return 1.0 - jnp.mean(t / jnp.sqrt(1.0 + t * t), axis=0)


def count_openness(Z, cellsize, lookup_pixels, threshold_angle, fast=False,
                   how_fast=20):
    """Per-pixel counts of directions whose (positive - negative)
    openness difference exceeds +/- threshold (neilpy.py:1600-1610).

    Fused: positive and negative openness for all 8 directions come out
    of ONE ladder scan — ``O_pos_d - O_neg_d = atan(-mn_d) - atan(mx_d)``
    in radians, since negating Z negates the ratios.
    """
    mx, mn, seen = directional_ratio_extrema(
        Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
        directions=tuple(range(8)), fast=fast, how_fast=how_fast)
    pos = jnp.rad2deg(_angles_from_extrema(mx, seen))
    neg = jnp.rad2deg(_angles_from_extrema(-mn, seen))
    diff = pos - neg
    t = jnp.float32(threshold_angle)
    num_pos = jnp.sum(diff > t, axis=0).astype(jnp.uint8)
    num_neg = jnp.sum(diff < -t, axis=0).astype(jnp.uint8)
    return num_pos, num_neg


def classes_from_counts(num_pos, num_neg):
    """J&S 9x9 table lookup as a fused 81-way select chain.

    A select chain fuses into the producing program's epilogue (also
    inside the Pallas kernel), where an ``lut[num_pos, num_neg]``
    gather would be a separate pass.
    """
    tbl = np.asarray(jasiewicz_stepinski_table()).ravel()
    idx = num_pos.astype(jnp.int32) * 9 + num_neg.astype(jnp.int32)
    out = jnp.full(idx.shape, int(tbl[0]), jnp.int32)
    for k in range(1, 81):
        out = jnp.where(idx == k, int(tbl[k]), out)
    return out.astype(jnp.uint8)


def geomorphons(Z, cellsize=1, lookup_pixels=1, threshold_angle=1,
                enhance=False, fast=False, how_fast=20, engine="auto"):
    """Geomorphon classes 1-10 from openness counts + the J&S 9x9
    lookup (neilpy.py:1617-1654), with the optional 'enhance'
    correction-of-forms second pass.

    ``engine``: 'auto' routes the ladder through the fused Pallas
    kernel on the GPU (classes equal to the XLA scan except at f32
    decision ties); 'xla' / 'pallas' force a path.
    """
    engine = resolve_engine(engine)
    enhance = enhance and lookup_pixels > 16
    if engine == "pallas":
        from .pallas_scan import geomorphons_pallas, openness_counts_pallas
        kw = dict(cellsize=float(cellsize),
                  threshold_angle=float(threshold_angle),
                  how_fast=int(how_fast))
        if not enhance:
            return geomorphons_pallas(Z, lookup_pixels=int(lookup_pixels),
                                      fast=bool(fast), **kw)
        counts = lambda lp, f: openness_counts_pallas(
            Z, lookup_pixels=int(lp), fast=bool(f), **kw)
    else:
        counts = lambda lp, f: count_openness(Z, cellsize, lp,
                                              threshold_angle, f, how_fast)
    G = classes_from_counts(*counts(lookup_pixels, fast))
    if enhance:
        lookup_sm = max(int(np.floor(lookup_pixels / 4)), 4)
        G_sm = classes_from_counts(*counts(lookup_sm, False))
        G = jnp.where((G == 4) & (G_sm == 1), 1, G)
        G = jnp.where((G == 8) & (G_sm == 1), 1, G)
        G = jnp.where((G == 2) | (G == 3), G_sm, G)
    return G


# Aliases used in the reference notebooks
get_geomorphons = geomorphons
get_geomorphon_from_openness = geomorphons


def ternary_pattern_from_openness(Z, cellsize=1, lookup_pixels=1,
                                  threshold_angle=0,
                                  use_negative_openness=True, lowest=False,
                                  engine="auto"):
    """8-direction ternary code packed base-3 into uint16
    (neilpy.py:1404-1430).  Direction i contributes digit
    {0: lower, 1: equal, 2: higher} * 3**i."""
    engine = resolve_engine(engine)
    if engine == "pallas":
        # fused in-kernel reduction: digits compared exactly in tangent
        # space and packed base-3 inside the kernel — one plane write
        # instead of 16 (only f32 decision ties can differ from
        # the angle-space XLA path)
        from .pallas_scan import ternary_pallas
        tc = ternary_pallas(
            Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
            threshold_angle=float(threshold_angle),
            use_negative_openness=bool(use_negative_openness))
    else:
        mx, mn, seen = directional_ratio_extrema(
            Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
            directions=tuple(range(8)))
        pos = jnp.rad2deg(_angles_from_extrema(mx, seen))
        if use_negative_openness:
            neg = jnp.rad2deg(_angles_from_extrema(-mn, seen))
            O = pos - neg
        else:
            O = pos - 90.0
        t = jnp.float32(threshold_angle)
        digits = jnp.ones(O.shape, dtype=jnp.uint32)
        digits = jnp.where(O > t, jnp.uint32(2), digits)
        digits = jnp.where(O < -t, jnp.uint32(0), digits)
        pows = jnp.asarray(3 ** np.arange(8), dtype=jnp.uint32)
        tc = jnp.sum(digits * pows[:, None, None],
                     axis=0).astype(jnp.uint16)
    if lowest:
        tc = jnp.asarray(lowest_equivalent_table())[tc.astype(jnp.int32)]
    return tc


def geomorphons2(Z, cellsize=1, lookup_pixels=5, threshold_angle=1,
                 use_negative_openness=True, method="loose", outfile=None,
                 out_transform=None, engine="auto"):
    """Geomorphons via ternary pattern -> canonical code -> class LUT
    (neilpy.py:1579-1596), with optional paletted PNG + worldfile out.

    The reference pipeline is ternary code -> lowest-equivalent LUT ->
    'loose' class LUT; since the 'loose' class depends only on the
    per-direction digit COUNTS (js[count('2'), count('0')],
    core/codes.py), which rotations/reflections preserve, both
    6561-entry gathers collapse to the fused count classifier —
    bit-identical output, no big-array gathers.
    """
    engine = resolve_engine(engine)
    if engine == "pallas" and use_negative_openness:
        # with negative openness the digit counts ARE the geomorphon
        # counts (O = pos - neg thresholded both ways) -> the fused
        # tangent-space counts kernel computes them directly
        from .pallas_scan import openness_counts_pallas
        num2, num0 = openness_counts_pallas(
            Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
            threshold_angle=float(threshold_angle))
        G = classes_from_counts(num2, num0)
    else:
        if engine == "pallas":
            from .pallas_scan import directional_extrema_pallas
            mx, mn = directional_extrema_pallas(
                Z, cellsize=float(cellsize),
                lookup_pixels=int(lookup_pixels))
            seen = mx > -jnp.inf
        else:
            mx, mn, seen = directional_ratio_extrema(
                Z, cellsize=float(cellsize),
                lookup_pixels=int(lookup_pixels),
                directions=tuple(range(8)))
        if use_negative_openness:
            pos = jnp.rad2deg(_angles_from_extrema(mx, seen))
            O = pos - jnp.rad2deg(_angles_from_extrema(-mn, seen))
            t = jnp.float32(threshold_angle)
            num2 = jnp.sum(O > t, axis=0).astype(jnp.uint8)
            num0 = jnp.sum(O < -t, axis=0).astype(jnp.uint8)
        else:
            # O = pos - 90 = -atan(mx) deg, so threshold directly in
            # tangent space (atan is monotone): O > t <=> mx < -tan(t);
            # unseen directions give pos = +inf (digit '2'), as in the
            # angle formulation
            T = jnp.float32(np.tan(np.radians(float(threshold_angle))))
            num2 = jnp.sum((mx < -T) | ~seen, axis=0).astype(jnp.uint8)
            num0 = jnp.sum(seen & (mx > T), axis=0).astype(jnp.uint8)
        G = classes_from_counts(num2, num0)
    if outfile is not None:
        from ..io.png import write_paletted_png
        from ..core.codes import geomorphon_cmap
        write_paletted_png(outfile, np.asarray(G), geomorphon_cmap())
        if out_transform is not None:
            from ..io.worldfile import write_worldfile
            write_worldfile(out_transform, outfile[:-3] + "pgw")
    return G
