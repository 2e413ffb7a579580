"""Pallas ladder kernel for openness, skyview, ternary codes and
geomorphons, compiled for the GPU through Triton.

The XLA engine (``ops.visibility.directional_ratio_extrema``) runs the
ladder as 8 directions x R steps of whole-raster passes: every step
reads a shifted plane, Z, mx and mn from device memory and writes mx
and mn back (~24 B/px per step, ~9.6 KB/px at R=50).  This kernel
computes each output block in one program instead:

* one program per power-of-two output block ``(BH, BW)``; blocks are
  independent, so thousands are in flight and nothing is carried from
  one block to another;
* the NaN-padded input stays unblocked: each ladder step loads its
  shifted ``(BH, BW)`` window with ``pl.ds`` at a dynamic offset inside
  a ``fori_loop`` (the windows a block revisits are served from L1/L2),
  and the running ``mx``/``mn`` live in registers;
* the epilogue is fused: the edge-replication correction, then either
  the tangent-space threshold compare + direction counts (+ the J&S
  class select), the openness / skyview / ternary reduction over the 8
  directions, or the raw per-direction extrema.

Every ratio is computed exactly as the XLA engine computes it
(``(src - Z) / (cellsize * w_d * L)`` in f32, NaN skipped by
compare-select), so the extrema are bit-identical to the XLA scan.  The
counts compare ``atan(-mn) - atan(mx)`` against the threshold exactly
in tangent space, where the XLA engine compares rounded angles, so the
two engines can differ only at f32 decision ties.

``pallas_call`` names the Triton route through its ``CompilerParams``.
On the CPU the same kernel runs in Pallas interpret mode (tests);
``backend.resolve_interpret`` refuses a compiled kernel there.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..backend import resolve_interpret
from ..core.shift import OFFSETS, STEP_LENGTH
from .visibility import classes_from_counts

__all__ = ["openness_counts_pallas", "openness_counts_pallas_block",
           "directional_extrema_pallas", "geomorphons_pallas",
           "openness_pallas", "skyview_pallas", "ternary_pallas",
           "DEFAULT_BLOCK"]

#: output block (rows, cols) and Triton warps per program
DEFAULT_BLOCK = (32, 64)
_NUM_WARPS = 4

#: outputs per mode: (dtype, leading extra dim or None)
_MODE_OUTPUTS = {
    "extrema": ((jnp.float32, 8), (jnp.float32, 8)),
    "counts": ((jnp.uint8, None), (jnp.uint8, None)),
    "classes": ((jnp.uint8, None),),
    "openness": ((jnp.float32, None), (jnp.float32, None)),
    "svf": ((jnp.float32, None),),
    "ternary": ((jnp.float32, None),),
}


def _fast_ladder(R, how_fast):
    """Static tuple form of the reference's progressive window
    (neilpy.py:1314-1321), shared with the XLA scan so both engines
    visit identical L levels."""
    from ..core.codes import progressive_window
    return tuple(int(v) for v in progressive_window(1, R, how_fast))


def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _block_for(shape, block):
    """Clamp the requested power-of-two block to the raster so a small
    input is not padded to a whole large block."""
    BH, BW = block
    for b in (BH, BW):
        if b < 1 or b & (b - 1):
            raise ValueError(f"block dims must be powers of two, got {block}")
    return (min(BH, _pow2_at_least(shape[0])),
            min(BW, _pow2_at_least(shape[1])))


def _tangent_compare(mx, mn, T):
    """(gt, lt): ``atan(a) - atan(b) > t`` and ``< -t`` for
    ``a = -mn``, ``b = mx``, evaluated exactly in tangent space:
    ``diff > t  <=>  (1+ab > 0) ? (a-b) > tan(t)(1+ab) : a > b``
    (valid for 0 <= t < pi/2; |diff| > pi/2 iff 1+ab <= 0).  Unseen
    directions (mx = -inf) compare False both ways."""
    a = -mn
    b = mx
    denom = 1.0 + a * b
    s = a - b
    td = T * denom
    wide = denom <= 0.0
    narrow = denom > 0.0
    seen = mx > -jnp.inf
    gt = ((wide & (a > b)) | (narrow & (s > td))) & seen
    lt = ((wide & (a < b)) | (narrow & (s < -td))) & seen
    return gt, lt


def _ladder_kernel(org_ref, z_ref, *out_refs, BH, BW, R, H, W, cellsize,
                   mode, threshold_deg, neg_mode, ladder):
    """One output block: the 8-direction ladder plus the fused
    epilogue of ``mode``.  ``z_ref`` is the whole NaN-padded raster
    (R-wide frame, block-multiple bottom/right padding); ``org_ref``
    holds the global (row, col) of this array's core origin, so a
    shard's block applies the GLOBAL raster edge rule; (H, W) is the
    global raster shape."""
    i = pl.program_id(0)
    j = pl.program_id(1)
    r0 = i * BH
    c0 = j * BW
    core = z_ref[pl.ds(r0 + R, BH), pl.ds(c0 + R, BW)]
    rows = lax.broadcasted_iota(jnp.int32, (BH, BW), 0) + (r0 + org_ref[0])
    cols = lax.broadcasted_iota(jnp.int32, (BH, BW), 1) + (c0 + org_ref[1])
    Rmax = ladder[-1] if ladder is not None else R
    T = math.tan(math.radians(threshold_deg))
    zero = jnp.zeros((BH, BW), jnp.float32)
    half_pi = jnp.float32(np.pi / 2)

    if mode in ("counts", "classes"):
        accs = (jnp.zeros((BH, BW), jnp.int32),) * 2
    elif mode == "openness":
        accs = (zero, zero)
    elif mode in ("svf", "ternary"):
        accs = (zero,)
    else:
        accs = ()

    for d in range(8):
        dr, dc = OFFSETS[d]
        # the XLA engine's f32 denominator, cellsize * w_d * L
        cw = np.float32(cellsize) * np.float32(STEP_LENGTH[d])

        def step(L, carry, dr=dr, dc=dc, cw=cw):
            mx, mn = carry
            src = z_ref[pl.ds(r0 + R + dr * L, BH),
                        pl.ds(c0 + R + dc * L, BW)]
            Lf = (jnp.float32(L) if isinstance(L, int)
                  else L.astype(jnp.float32))
            ratio = (src - core) / (jnp.float32(cw) * Lf)
            # compare-select skips NaN (padding or nodata holes)
            mx = jnp.where(ratio > mx, ratio, mx)
            mn = jnp.where(ratio < mn, ratio, mn)
            return mx, mn

        carry = (jnp.full((BH, BW), -jnp.inf, jnp.float32),
                 jnp.full((BH, BW), jnp.inf, jnp.float32))
        if ladder is not None:
            for L in ladder:
                carry = step(L, carry)
        else:
            carry = lax.fori_loop(1, R + 1, step, carry)
        mx, mn = carry

        # edge replication: an out-of-range step contributes ratio
        # exactly 0 (out-of-range is monotone in L, so the largest
        # step decides for the whole ladder)
        sr = rows + dr * Rmax
        sc = cols + dc * Rmax
        oob = (sr < 0) | (sr >= H) | (sc < 0) | (sc >= W)
        mx = jnp.where(oob, jnp.maximum(mx, 0.0), mx)
        mn = jnp.where(oob, jnp.minimum(mn, 0.0), mn)

        if mode == "extrema":
            out_refs[0][d, :, :] = mx
            out_refs[1][d, :, :] = mn
        elif mode in ("counts", "classes"):
            gt, lt = _tangent_compare(mx, mn, T)
            accs = (accs[0] + gt.astype(jnp.int32),
                    accs[1] + lt.astype(jnp.int32))
        elif mode == "openness":
            seen = mx > -jnp.inf
            pos = jnp.where(seen, half_pi - jnp.arctan(mx), jnp.inf)
            neg = jnp.where(seen, half_pi - jnp.arctan(-mn), jnp.inf)
            accs = (accs[0] + pos, accs[1] + neg)
        elif mode == "svf":
            t = jnp.maximum(mx, 0.0)  # also absorbs unseen (-inf)
            accs = (accs[0] + t / jnp.sqrt(1.0 + t * t),)
        else:  # ternary digit {0: lower, 1: equal, 2: higher} * 3**d
            if neg_mode:
                gt, lt = _tangent_compare(mx, mn, T)
            else:
                # O = pos - 90 = -atan(mx) deg: O > t <=> mx < -tan(t);
                # unseen -> pos = +inf -> digit 2 (as in the XLA path)
                seen = mx > -jnp.inf
                gt = (mx < -T) | jnp.logical_not(seen)
                lt = seen & (mx > T)
            digit = (1.0 + gt.astype(jnp.float32)
                     - lt.astype(jnp.float32))
            accs = (accs[0] + digit * float(3 ** d),)

    if mode == "classes":
        out_refs[0][...] = classes_from_counts(*accs)
    elif mode == "counts":
        out_refs[0][...] = accs[0].astype(jnp.uint8)
        out_refs[1][...] = accs[1].astype(jnp.uint8)
    else:
        for ref, acc in zip(out_refs, accs):
            ref[...] = acc


def _ladder_call(Zp, org, *, core_shape, global_shape, R, block, mode,
                 cellsize, threshold_deg=0.0, neg_mode=True, ladder=None,
                 interpret=None, vma=None):
    """Run ``_ladder_kernel`` over a raster whose core ``core_shape``
    sits inside an R-wide frame of ``Zp`` (NaN or real halo data);
    pads bottom/right to whole blocks and crops the outputs back."""
    interpret = resolve_interpret(interpret)
    h, w = core_shape
    BH, BW = _block_for(core_shape, block)
    Hp = -(-h // BH) * BH
    Wp = -(-w // BW) * BW
    Zp = jnp.pad(jnp.asarray(Zp, jnp.float32),
                 ((0, Hp - h), (0, Wp - w)), constant_values=jnp.nan)
    kernel = partial(_ladder_kernel, BH=BH, BW=BW, R=R,
                     H=int(global_shape[0]), W=int(global_shape[1]),
                     cellsize=float(cellsize), mode=mode,
                     threshold_deg=float(threshold_deg),
                     neg_mode=bool(neg_mode), ladder=ladder)
    out_shape, out_specs = [], []
    for dtype, lead in _MODE_OUTPUTS[mode]:
        shape = (Hp, Wp) if lead is None else (lead, Hp, Wp)
        kw = {} if vma is None else {"vma": frozenset(vma)}
        out_shape.append(jax.ShapeDtypeStruct(shape, dtype, **kw))
        out_specs.append(
            pl.BlockSpec((BH, BW), lambda i, j: (i, j)) if lead is None
            else pl.BlockSpec((lead, BH, BW), lambda i, j: (0, i, j)))
    outs = pl.pallas_call(
        kernel,
        grid=(Hp // BH, Wp // BW),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=tuple(out_specs),
        out_shape=tuple(out_shape),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"ladder_{mode}",
    )(jnp.asarray(org, jnp.int32), Zp)
    return tuple(o[..., :h, :w] for o in outs)


def _single(Z, lookup_pixels, block, mode, cellsize, fast=False,
            how_fast=20, interpret=None, **kw):
    """Single-device entry: NaN frame of width R around the raster."""
    Z = jnp.asarray(Z, dtype=jnp.float32)
    R = int(lookup_pixels)
    Zp = jnp.pad(Z, R, constant_values=jnp.nan)
    ladder = _fast_ladder(R, how_fast) if fast else None
    return _ladder_call(Zp, jnp.zeros((2,), jnp.int32),
                        core_shape=Z.shape, global_shape=Z.shape, R=R,
                        block=block, mode=mode, cellsize=cellsize,
                        ladder=ladder, interpret=interpret, **kw)


_STATIC = ("lookup_pixels", "block", "interpret", "cellsize", "fast",
           "how_fast")


@partial(jax.jit, static_argnames=_STATIC)
def directional_extrema_pallas(Z, cellsize=1.0, lookup_pixels=1,
                               block=DEFAULT_BLOCK, interpret=None,
                               fast=False, how_fast=20):
    """Per-direction (8, H, W) running max/min slope ratios — the
    kernel form of ``visibility.directional_ratio_extrema`` without the
    ``seen`` plane (``seen == mx > -inf``)."""
    return _single(Z, lookup_pixels, block, "extrema", cellsize, fast,
                   how_fast, interpret)


@partial(jax.jit, static_argnames=_STATIC + ("threshold_angle",))
def openness_counts_pallas(Z, cellsize=1.0, lookup_pixels=1,
                           threshold_angle=1.0, block=DEFAULT_BLOCK,
                           interpret=None, fast=False, how_fast=20):
    """(num_pos, num_neg) uint8 direction counts for geomorphons
    (``visibility.count_openness`` up to f32 decision ties)."""
    return _single(Z, lookup_pixels, block, "counts", cellsize, fast,
                   how_fast, interpret, threshold_deg=threshold_angle)


@partial(jax.jit, static_argnames=_STATIC + ("threshold_angle",))
def geomorphons_pallas(Z, cellsize=1.0, lookup_pixels=1,
                       threshold_angle=1.0, block=DEFAULT_BLOCK,
                       interpret=None, fast=False, how_fast=20):
    """Geomorphon classes 1-10 with the J&S select fused into the
    kernel (``visibility.geomorphons`` without the enhance pass)."""
    (G,) = _single(Z, lookup_pixels, block, "classes", cellsize, fast,
                   how_fast, interpret, threshold_deg=threshold_angle)
    return G


@partial(jax.jit, static_argnames=_STATIC)
def openness_pallas(Z, cellsize=1.0, lookup_pixels=1,
                    block=DEFAULT_BLOCK, interpret=None, fast=False,
                    how_fast=20):
    """(positive, negative) Yokoyama openness in degrees from one
    ladder pass, reduced over the 8 directions in-kernel (reference
    openness neilpy.py:1325-1356).  atan runs in the kernel, so the
    result is within a few ulp of the XLA epilogue, not bit-equal."""
    pos_sum, neg_sum = _single(Z, lookup_pixels, block, "openness",
                               cellsize, fast, how_fast, interpret)
    k = jnp.float32(180.0 / np.pi / 8.0)
    return pos_sum * k, neg_sum * k


@partial(jax.jit, static_argnames=_STATIC)
def skyview_pallas(Z, cellsize=1.0, lookup_pixels=1, block=DEFAULT_BLOCK,
                   interpret=None, fast=False, how_fast=20):
    """Skyview factor 1 - mean_d t/sqrt(1+t^2), t = max(mx_d, 0),
    reduced in-kernel (reference skyview_factor neilpy.py:1360-1384)."""
    (s,) = _single(Z, lookup_pixels, block, "svf", cellsize, fast,
                   how_fast, interpret)
    return 1.0 - s * jnp.float32(0.125)


@partial(jax.jit, static_argnames=_STATIC + ("threshold_angle",
                                             "use_negative_openness"))
def ternary_pallas(Z, cellsize=1.0, lookup_pixels=1, threshold_angle=0.0,
                   use_negative_openness=True, block=DEFAULT_BLOCK,
                   interpret=None, fast=False, how_fast=20):
    """Base-3 packed 8-direction ternary code (uint16), digits compared
    exactly in tangent space (reference ternary_pattern_from_openness
    neilpy.py:1404-1430)."""
    (tc,) = _single(Z, lookup_pixels, block, "ternary", cellsize, fast,
                    how_fast, interpret, threshold_deg=threshold_angle,
                    neg_mode=use_negative_openness)
    return tc.astype(jnp.uint16)


def openness_counts_pallas_block(block_haloed, origin, global_shape,
                                 lookup_pixels, cellsize=1.0,
                                 threshold_angle=1.0, block=DEFAULT_BLOCK,
                                 interpret=None, vma=None, fast=False,
                                 how_fast=20):
    """Per-device entry for ``shard_map``: ``block_haloed`` is a local
    block already surrounded by an R-wide halo of real neighbour data
    (NaN beyond the raster); ``origin`` is the global (row, col) of the
    block core (traced ints), passed to the kernel as an ordinary input.
    Returns core-shaped (num_pos, num_neg) uint8 counts identical to
    the single-device kernel over the same global raster."""
    R = int(lookup_pixels)
    core = (block_haloed.shape[0] - 2 * R, block_haloed.shape[1] - 2 * R)
    org = jnp.stack([jnp.asarray(origin[0], jnp.int32),
                     jnp.asarray(origin[1], jnp.int32)])
    ladder = _fast_ladder(R, how_fast) if fast else None
    return _ladder_call(block_haloed, org, core_shape=core,
                        global_shape=global_shape, R=R, block=block,
                        mode="counts", cellsize=cellsize,
                        threshold_deg=threshold_angle, ladder=ladder,
                        interpret=interpret, vma=vma)
