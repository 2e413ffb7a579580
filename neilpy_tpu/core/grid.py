"""Raster container and small grid utilities.

The reference passes bare numpy arrays plus a separate affine transform
everywhere; this framework offers the same functional surface but
also a light ``Raster`` pytree so jitted pipelines can move a grid and
its georeferencing together.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import numpy as np
import jax.numpy as jnp

from .affine import Affine


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Raster:
    """A georeferenced grid: device array + static georeferencing.

    ``data`` is the pytree leaf; transform / crs / nodata ride along as
    static metadata so a ``Raster`` can pass through ``jit`` unscathed.
    """

    data: Any
    transform: Affine = dataclasses.field(
        default_factory=Affine.identity, metadata=dict(static=True))
    crs: Optional[object] = dataclasses.field(default=None,
                                              metadata=dict(static=True))
    nodata: Optional[float] = dataclasses.field(default=None,
                                                metadata=dict(static=True))

    @property
    def shape(self):
        return self.data.shape

    @property
    def cellsize(self) -> float:
        cx, cy = abs(self.transform.a), abs(self.transform.e)
        return (cx + cy) / 2.0 if abs(cx - cy) < 1e-8 else cx

    @property
    def bounds(self):
        """(west, south, east, north)."""
        h, w = self.data.shape[:2]
        x0, y0 = self.transform * (0, 0)
        x1, y1 = self.transform * (w, h)
        return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))

    def with_data(self, data) -> "Raster":
        return dataclasses.replace(self, data=data)


# ----------------------------------------------------------------------
# Small conveniences (parity: neilpy.py:87-94, 1095-1102, 1221-1224,
# 1932-1934, 1961-1974)
# ----------------------------------------------------------------------

def keep_xyz(df, x=None, y=None, z=None):
    """Bounding-box filter on a point dataframe (neilpy.py:87-94)."""
    for col, rng in (("x", x), ("y", y), ("z", z)):
        if rng is not None:
            df = df[(df[col] >= rng[0]) & (df[col] <= rng[1])]
    return df


def edges_from_IT(image, transform):
    """x/y bin edges of a georeferenced image (neilpy.py:1095-1102)."""
    r, c = np.shape(image)[0], np.shape(image)[1]
    cols = np.arange(c + 1, dtype=np.float64)
    rows = np.arange(r + 1, dtype=np.float64)
    x_edges, _ = transform * (cols, np.zeros_like(cols))
    _, y_edges = transform * (np.zeros_like(rows), rows)
    return x_edges, y_edges


def unique_rows(a):
    """Deduplicate rows of a 2-D array (neilpy.py:1221-1224)."""
    return np.unique(np.ascontiguousarray(a), axis=0)


def cutter(x, r, c):
    """Split a raster into an r x c list-of-lists of tiles
    (neilpy.py:1932-1934)."""
    return [np.hsplit(row, c) for row in np.vsplit(np.asarray(x), r)]


def normalize(X, xrange=("min", "max"), yrange=(0, 1)):
    """Piecewise-linear remap with min/max/mean/median keywords
    (neilpy.py:1961-1974)."""
    X = jnp.asarray(X)
    fixed = []
    for item in xrange:
        if item == "max":
            item = jnp.nanmax(X)
        elif item == "min":
            item = jnp.nanmin(X)
        elif item == "mean":
            item = jnp.nanmean(X)
        elif item == "median":
            item = jnp.nanmedian(X)
        fixed.append(item)
    return jnp.interp(X, jnp.stack(fixed), jnp.asarray(yrange, dtype=X.dtype))
