"""Directional shift primitives — the core stencil building block.

The reference library's single most important primitive is ``ashift``
(reference: neilpy/neilpy.py:1290-1308): copy a raster shifted ``n``
pixels in one of 8 compass directions (clockwise from the upper-left),
where positions whose source pixel falls outside the array *keep their
original value* (NOT wrap, NOT zero, NOT edge-clamp).

Design: a shift is expressed as ``jnp.roll`` (which XLA
lowers to two static slices + concatenate) combined with a validity
mask built from iotas.  This keeps every op statically shaped and
fusible, and the same (rolled, valid) decomposition is what the fused
openness/geomorphon scan kernels build on (see ops/visibility.py).

Direction convention (clockwise from upper-left = direction 0)::

      0 1 2
      7 . 3
      6 5 4

``ashift(Z, d, n)[r, c] == Z[r + dr*n, c + dc*n]`` when in bounds, else
``Z[r, c]``, with (dr, dc) = OFFSETS[d].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# (row, col) offset of the *source* pixel for each direction.
# direction d "grabs" the pixel n steps away toward compass direction d.
OFFSETS = (
    (-1, -1),  # 0: upper-left
    (-1, 0),   # 1: up
    (-1, 1),   # 2: upper-right
    (0, 1),    # 3: right
    (1, 1),    # 4: lower-right
    (1, 0),    # 5: down
    (1, -1),   # 6: lower-left
    (0, -1),   # 7: left
)

# Euclidean step length per unit shift for each direction (diagonals sqrt(2)).
# Matches reference dlist indexing: dlist[direction % 2] with
# dlist = [sqrt(2), 1] (neilpy.py:1337, 1346).
STEP_LENGTH = tuple(2.0 ** 0.5 if d % 2 == 0 else 1.0 for d in range(8))


def shift_valid_mask(shape, direction, n):
    """Boolean mask of positions whose shifted source is inside the array.

    ``n`` may be a traced integer (e.g. a ``fori_loop`` index).
    """
    h, w = shape
    dr, dc = OFFSETS[direction]
    rows = lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h, w), 1)
    sr = rows + dr * n
    sc = cols + dc * n
    return (sr >= 0) & (sr < h) & (sc >= 0) & (sc < w)


def rolled(Z, direction, n):
    """``out[r, c] = Z[r + dr*n, c + dc*n]`` with wraparound (no masking)."""
    dr, dc = OFFSETS[direction]
    return jnp.roll(Z, shift=(-dr * n, -dc * n), axis=(0, 1))


def ashift(Z, direction, n=1):
    """Edge-fallback directional shift (parity with neilpy.py:1290-1308).

    Out-of-range positions keep the *original* value of ``Z`` at that
    position.  Directions outside 0-7 return an unchanged copy — this
    reproduces the reference's fall-through behaviour, which
    ``wilson_gallant_curvature`` (neilpy.py:767-768) silently relies on.
    """
    Z = jnp.asarray(Z)
    if direction not in range(8):
        return Z
    rz = rolled(Z, direction, n)
    mask = shift_valid_mask(Z.shape, direction, n)
    return jnp.where(mask, rz, Z)


def ashift_fill(Z, direction, n=1, fill=jnp.nan):
    """Directional shift with a constant fill for out-of-range positions."""
    Z = jnp.asarray(Z)
    rz = rolled(Z, direction, n)
    mask = shift_valid_mask(Z.shape, direction, n)
    return jnp.where(mask, rz, jnp.asarray(fill, dtype=Z.dtype))


def gradient2d(Z, spacing=1.0):
    """``np.gradient`` on a 2-D array: central differences in the
    interior, one-sided at the edges.  Returns (gy, gx).

    Used by slope/aspect/hillshade/pssm (reference neilpy.py:460, 475,
    849, 1785).  Implemented with static pads/slices so it fuses under
    jit instead of materialising index arrays.
    """
    Z = jnp.asarray(Z)

    def _axis_grad(A, axis):
        upper = jnp.take(A, jnp.arange(2, A.shape[axis]), axis=axis)
        lower = jnp.take(A, jnp.arange(0, A.shape[axis] - 2), axis=axis)
        interior = (upper - lower) / (2.0 * spacing)
        first = (jnp.take(A, jnp.array([1]), axis=axis)
                 - jnp.take(A, jnp.array([0]), axis=axis)) / spacing
        last = (jnp.take(A, jnp.array([A.shape[axis] - 1]), axis=axis)
                - jnp.take(A, jnp.array([A.shape[axis] - 2]), axis=axis)) / spacing
        return jnp.concatenate([first, interior, last], axis=axis)

    return _axis_grad(Z, 0), _axis_grad(Z, 1)


def pad_edge(Z, pad):
    """Edge-replicate pad (scipy.ndimage mode='nearest')."""
    return jnp.pad(Z, pad, mode="edge")


def pad_reflect(Z, pad):
    """Edge-inclusive reflect pad (scipy.ndimage mode='reflect'),
    i.e. ``(d c b a | a b c d)`` — numpy's 'symmetric'."""
    return jnp.pad(Z, pad, mode="symmetric")
