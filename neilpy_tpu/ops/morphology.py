"""Grayscale morphology with disk structuring elements on the device.

Reference dependency: SMRF's progressive filter calls
``skimage.morphology.opening(surface, disk(w))`` for w = 1..18
(neilpy/neilpy.py:1667-1670), which is scipy ``grey_erosion`` followed
by ``grey_dilation`` with reflect boundary handling.

Design
------
A disk is not separable, but it decomposes *exactly* into horizontal
runs: for each row offset dy the footprint covers [-kx(dy), kx(dy)]
with kx = floor(sqrt(r^2 - dy^2)).  Erosion therefore factors as

    E(Z)[p] = min over dy of ( rowmin_{kx(dy)}(Z)[p + dy] )

where ``rowmin_k`` is a sliding horizontal min of half-width k.  All
row mins are served from one *sparse table*: log2(2r+1) doubling
passes build anchored mins of power-of-two widths, and any width w is
the min of two overlapping power-of-two windows.  Total cost is
O(log r) doubling passes + O(r) row combines of static slices — all
fusible, no gathers, no data-dependent shapes.

Dilation is the dual (max, reflected footprint; the disk is symmetric).
Boundaries replicate scipy's ``mode='reflect'`` via symmetric padding.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from ..core.codes import disk, disk_run_halfwidths
from ..core.shift import pad_reflect

__all__ = ["grey_erosion_disk", "grey_dilation_disk", "opening_disk",
           "grey_erosion", "grey_dilation", "opening", "erosion",
           "dilation"]


def _sparse_table(P, max_width, reduce_fn):
    """Anchored row-window reductions: levels[k][.., i] reduces
    P[.., i : i + 2**k].  Arrays shrink along the row axis as k grows."""
    levels = [P]
    k = 0
    while (1 << (k + 1)) <= max_width:
        prev = levels[-1]
        step = 1 << k
        nxt = reduce_fn(prev[:, :-step], prev[:, step:])
        levels.append(nxt)
        k += 1
    return levels


def _row_window(levels, width, start_col, ncols, reduce_fn):
    """Reduction over columns [start_col, start_col + width) for every
    output column, via two overlapping power-of-two windows."""
    k = int(np.floor(np.log2(width)))
    step = 1 << k
    A = levels[k]
    left = A[:, start_col:start_col + ncols]
    right = A[:, start_col + width - step:start_col + width - step + ncols]
    return reduce_fn(left, right)


def _disk_morph_padded(P, radius, reduce_fn):
    """Disk min/max over a block already padded by ``radius`` on every
    side (halo-exchanged shards or host reflect padding); returns the
    core.  The run decomposition reads only [-r, r] neighbourhoods, so
    the caller controls boundary semantics entirely via the padding."""
    r = int(radius)
    H, W = P.shape[0] - 2 * r, P.shape[1] - 2 * r
    dys, kxs = disk_run_halfwidths(r)
    max_width = int(2 * kxs.max() + 1)
    levels = _sparse_table(P, max_width, reduce_fn)

    # group row offsets by half-width so each row-min is computed once
    by_kx = {}
    for dy, kx in zip(dys, kxs):
        by_kx.setdefault(int(kx), []).append(int(dy))

    out = None
    for kx, dy_list in by_kx.items():
        width = 2 * kx + 1
        # rowmin over [c - kx, c + kx] in padded coords for output col c:
        # padded start = (c + r) - kx
        rm = _row_window(levels, width, r - kx, W, reduce_fn)
        for dy in dy_list:
            band = rm[r + dy: r + dy + H, :]
            out = band if out is None else reduce_fn(out, band)
    return out


def _disk_morph(Z, radius, reduce_fn):
    Z = jnp.asarray(Z)
    if Z.dtype not in (jnp.float32, jnp.float64):
        Z = Z.astype(jnp.float32)  # f64 preserved for the exact path
    return _disk_morph_padded(pad_reflect(Z, int(radius)), radius,
                              reduce_fn)


@partial(jax.jit, static_argnames=("radius",))
def grey_erosion_disk(Z, radius):
    """Grayscale erosion by ``disk(radius)`` (scipy reflect boundary)."""
    return _disk_morph(Z, radius, jnp.minimum)


@partial(jax.jit, static_argnames=("radius",))
def grey_dilation_disk(Z, radius):
    """Grayscale dilation by ``disk(radius)``."""
    return _disk_morph(Z, radius, jnp.maximum)


@partial(jax.jit, static_argnames=("radius",))
def opening_disk(Z, radius):
    """Grayscale opening (erosion then dilation) by ``disk(radius)`` —
    the SMRF ladder's workhorse (parity: skimage opening at
    neilpy.py:1670)."""
    return _disk_morph(_disk_morph(Z, radius, jnp.minimum), radius,
                       jnp.maximum)


# ----------------------------------------------------------------------
# Generic footprints (small/odd) — unrolled offset reduction.
# ----------------------------------------------------------------------
def _generic_morph(Z, footprint, reduce_fn):
    Z = jnp.asarray(Z, dtype=jnp.float32)
    fp = np.asarray(footprint).astype(bool)
    kh, kw = fp.shape
    ph, pw = kh // 2, kw // 2
    P = pad_reflect(Z, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    H, W = Z.shape
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if not fp[dy, dx]:
                continue
            band = P[dy:dy + H, dx:dx + W]
            out = band if out is None else reduce_fn(out, band)
    return out


def grey_erosion(Z, footprint):
    """Grayscale erosion by an arbitrary boolean footprint."""
    return _generic_morph(Z, footprint, jnp.minimum)


def grey_dilation(Z, footprint):
    """Grayscale dilation by an arbitrary boolean footprint
    (scipy convention: footprint mirrored; symmetric footprints are
    unaffected)."""
    fp = np.asarray(footprint)[::-1, ::-1]
    return _generic_morph(Z, fp, jnp.maximum)


def erosion(Z, footprint):
    return grey_erosion(Z, footprint)


def dilation(Z, footprint):
    return grey_dilation(Z, footprint)


def opening(Z, footprint):
    """Grayscale opening by an arbitrary footprint (skimage.opening
    semantics)."""
    return grey_dilation(grey_erosion(Z, footprint), np.asarray(footprint))
