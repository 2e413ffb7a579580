"""Point-cloud to raster gridding (``create_dem``).

Reference: neilpy/neilpy.py:1110-1166 — edges snapped to the cellsize
with a half-cell margin, a north-up affine, inverse-affine floor
binning, then a pandas ``groupby(flat_index).min()/.max()`` scatter.

Design
------
* Exact path: bin-index computation in **float64 on host** (numpy) —
  UTM coordinates (~1e5-1e6) with metre cells cannot survive f32
  without misbinning points near cell edges.
* Fast path (``device_bin=True``): the host does ONE f64 pass
  (subtracting the grid origin); the origin-relative coordinates span
  only the grid extent, so they are f32-safe, and the floor/clip/ravel
  binning fuses with the reduction in a single device program.
* Two reduction kernels, selected by ``method``:
  - ``"scatter"`` (default): ``array.at[idx].min/max`` (atomics
    on the GPU).
  - ``"sort"``: key-sort the (bin, z) pairs, segmented min/max via
    ``lax.associative_scan``, then gather per-cell results with a
    ``searchsorted`` — a scatter-free alternative (useful on backends
    where scatter serializes).
  min/max are exact in any float width, so the f32 device reduction
  bit-matches the f64 host groupby whenever inputs are f32-representable.
* ``bin_points`` is exposed separately so sharded pipelines can bin
  once and shard the (index, z) streams across devices, combining
  per-device partial grids with a min/max ``psum``-style tree.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core.affine import Affine

__all__ = ["create_dem", "create_dem_from_las", "bin_points",
           "bin_points_device",
           "scatter_reduce", "grid_points_device"]


def _floor2(x, v):
    return v * np.floor(x / v)


def _ceil2(x, v):
    return v * np.ceil(x / v)


def _grid_frame(x, y, cellsize=1, edges=None):
    """Shared host-side (f64) grid-frame computation: edge snapping and
    the north-up affine, exactly as the reference (neilpy.py:1117-1143):
    x edges from floor(min/cs)*cs - .5cs to ceil(max/cs)*cs + 1.5cs,
    y edges descending.  Returns (ny, nx, t, cellsize, in_range|None).
    """
    if np.size(x) == 0:
        raise ValueError("empty point set: cannot derive a grid frame")
    if edges is None:
        cellsize = float(cellsize)
        xedges = np.arange(_floor2(x.min(), cellsize) - .5 * cellsize,
                           _ceil2(x.max(), cellsize) + 1.5 * cellsize,
                           cellsize)
        yedges = np.arange(_ceil2(y.max(), cellsize) + .5 * cellsize,
                           _floor2(y.min(), cellsize) - 1.5 * cellsize,
                           -cellsize)
        in_range = None
    else:
        xedges, yedges = np.asarray(edges[0]), np.asarray(edges[1])
        out = ((x < xedges[0]) | (x > xedges[-1])
               | (y > yedges[0]) | (y < yedges[-1]))
        in_range = ~out
        cellsize = float(abs(xedges[1] - xedges[0]))
    nx, ny = len(xedges) - 1, len(yedges) - 1
    t = Affine.from_origin(xedges[0], yedges[0], cellsize, cellsize)
    return ny, nx, t, cellsize, in_range


def bin_points(x, y, cellsize=1, edges=None, native=None):
    """Compute grid shape, affine transform, and per-point flat bin
    indices (host, float64 — the exact path).

    Returns (flat_index int64 array, in_range bool array, (ny, nx), t).

    ``native=None`` (auto) dispatches to the multithreaded C++ kernel
    when built (50x numpy, identical output up to f64 associativity on
    bit-exact cell-edge hits); ``native=False`` forces numpy.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if native is None or native:
        from .binning_native import native_available, bin_points_native
        if native_available():
            try:
                return bin_points_native(x, y, cellsize, edges)
            except ValueError:
                if native:  # explicit request: surface the limit
                    raise
                # auto mode: >int32 grids fall back to numpy below
        elif native:
            raise RuntimeError("native binning requested but "
                               "libbinning.so is not built")
    ny, nx, t, cellsize, in_range = _grid_frame(x, y, cellsize, edges)
    if in_range is None:
        in_range = np.ones(x.shape, dtype=bool)
    c, r = (~t) * (x, y)
    c = np.floor(c).astype(np.int64)
    r = np.floor(r).astype(np.int64)
    # guard: out-of-range points map to bin 0 but are masked out
    c_cl = np.clip(c, 0, nx - 1)
    r_cl = np.clip(r, 0, ny - 1)
    in_range &= (c == c_cl) & (r == r_cl)
    flat = r_cl * nx + c_cl
    return flat, in_range, (ny, nx), t


def bin_points_device(x, y, cellsize=1, edges=None):
    """Fast-path frame computation for on-device binning.

    The host does exactly one f64 pass per axis (subtracting the grid
    origin); the returned origin-relative f32 coordinates span only the
    grid extent, where f32 resolution is sub-millimetre for km-scale
    grids — so the device floor reproduces the host binning except for
    points within one f32 ulp of a cell edge.

    Returns (x_rel f32, y_rel f32 (downward-positive), (ny, nx), t).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ny, nx, t, cellsize, _ = _grid_frame(x, y, cellsize, edges)
    from .binning_native import origin_shift_native
    shifted = origin_shift_native(x, y, t.c, t.f)
    if shifted is not None:
        return shifted[0], shifted[1], (ny, nx), t
    x_rel = (x - t.c).astype(np.float32)
    y_rel = (t.f - y).astype(np.float32)
    return x_rel, y_rel, (ny, nx), t


def _segment_reduce_sorted(idx, z, n_cells, bin_type):
    """Sort-based segment min/max: key-sort the (bin, z) pairs, run a
    segmented extremum ``associative_scan``, and gather each cell's
    segment tail via ``searchsorted``.  Equivalent to the scatter path
    but built entirely from sort/scan/gather, with no serialized scatter
    updates."""
    combine = jnp.maximum if bin_type == "max" else jnp.minimum
    sidx, sz = lax.sort((idx, z), num_keys=1)
    starts = jnp.concatenate([jnp.ones((1,), bool),
                              sidx[1:] != sidx[:-1]])

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, combine(va, vb))

    _, scanned = lax.associative_scan(comb, (starts, sz))
    cells = jnp.arange(n_cells, dtype=sidx.dtype)
    p = jnp.searchsorted(sidx, cells, side="right") - 1
    pc = jnp.maximum(p, 0)
    hit = (p >= 0) & (sidx[pc] == cells)
    return jnp.where(hit, scanned[pc], jnp.nan)


_INT32_MAX = 2**31 - 1


@partial(jax.jit, static_argnames=("n_cells", "bin_type", "method"))
def scatter_reduce(flat_index, z, valid, n_cells, bin_type="max",
                   method="scatter"):
    """Device min/max reduction of z into a flat grid of n_cells.

    Invalid points are routed to the reduction identity (scatter) or an
    out-of-grid sentinel bin (sort) so padded / out-of-range entries
    never contribute — this keeps the call jittable with a fixed
    point-count (pad freely).

    Grids with more than 2**31-1 cells cannot be addressed by the flat
    int32 index this kernel uses — they raise here rather than
    overflowing silently (the reference's pandas groupby is int64
    throughout, neilpy.py:1142-1151); `create_dem` routes such grids
    through the 2-D row/column scatter automatically.
    """
    if bin_type not in ("max", "min"):
        raise ValueError("This type not supported.")
    if n_cells > _INT32_MAX:
        raise ValueError(
            f"n_cells={n_cells} exceeds the int32 flat-index range; "
            "use the 2-D (row, col) scatter path (create_dem handles "
            "this automatically)")
    z = jnp.asarray(z, dtype=jnp.float32)
    idx = jnp.asarray(flat_index, dtype=jnp.int32)
    if method == "sort":
        idx = jnp.where(valid, idx, n_cells)
        return _segment_reduce_sorted(idx, z, n_cells, bin_type)
    if bin_type == "max":
        ident = -jnp.inf
        z = jnp.where(valid, z, ident)
        grid = jnp.full((n_cells,), ident, dtype=jnp.float32)
        grid = grid.at[idx].max(z, mode="drop")
        return jnp.where(jnp.isneginf(grid), jnp.nan, grid)
    else:
        ident = jnp.inf
        z = jnp.where(valid, z, ident)
        grid = jnp.full((n_cells,), ident, dtype=jnp.float32)
        grid = grid.at[idx].min(z, mode="drop")
        return jnp.where(jnp.isposinf(grid), jnp.nan, grid)


@partial(jax.jit, static_argnames=("ny", "nx", "bin_type"))
def _scatter_reduce_rc(r, c, z, valid, ny, nx, bin_type):
    """2-D (row, col) min/max scatter into an (ny, nx) grid.  Each
    index component fits int32 even when ny*nx exceeds 2**31 cells, so
    this is the overflow-safe path for ≥46,341² grids (the flat-index
    kernel would wrap silently)."""
    z = jnp.asarray(z, dtype=jnp.float32)
    r = jnp.asarray(r, dtype=jnp.int32)
    c = jnp.asarray(c, dtype=jnp.int32)
    if bin_type == "max":
        ident = -jnp.inf
        z = jnp.where(valid, z, ident)
        grid = jnp.full((ny, nx), ident, dtype=jnp.float32)
        grid = grid.at[r, c].max(z, mode="drop")
        return jnp.where(jnp.isneginf(grid), jnp.nan, grid)
    ident = jnp.inf
    z = jnp.where(valid, z, ident)
    grid = jnp.full((ny, nx), ident, dtype=jnp.float32)
    grid = grid.at[r, c].min(z, mode="drop")
    return jnp.where(jnp.isposinf(grid), jnp.nan, grid)


@partial(jax.jit, static_argnames=("ny", "nx", "bin_type", "method"))
def _grid_fused(x_rel, y_rel, z, inv_cs, ny, nx, bin_type, method):
    """One fused device program: floor-binning + validity + segment
    reduction, returning the (ny, nx) grid.  Runs entirely on device;
    the host only subtracted the grid origin (see
    ``bin_points_device``).  When the grid exceeds the int32 flat-index
    range, the scatter method switches to the 2-D (row, col) kernel."""
    c = jnp.floor(x_rel * inv_cs).astype(jnp.int32)
    r = jnp.floor(y_rel * inv_cs).astype(jnp.int32)
    valid = (c >= 0) & (c < nx) & (r >= 0) & (r < ny)
    if method == "scatter" and ny * nx > _INT32_MAX:
        return _scatter_reduce_rc(r, c, z, valid, ny, nx, bin_type)
    flat = jnp.where(valid, r * nx + c, ny * nx)
    grid = scatter_reduce(flat, z, valid, ny * nx, bin_type=bin_type,
                          method=method)
    return jnp.reshape(grid, (ny, nx))


@partial(jax.jit, static_argnames=("ny", "nx", "bin_type"),
         donate_argnums=(0,))
def _grid_scatter_accum(grid, x_rel, y_rel, z, inv_cs, ny, nx, bin_type):
    """One streamed chunk: floor-binning + scatter min/max into the
    carried (ny, nx) sentinel grid (±identity empty cells; NaN
    conversion happens once at the end of the stream).  The carry is
    donated, so the grid is updated in place on device across chunks.
    Indexing is 2-D (row, col) int32 — safe for grids beyond 2**31
    cells where a flat index would overflow."""
    c = jnp.floor(x_rel * inv_cs).astype(jnp.int32)
    r = jnp.floor(y_rel * inv_cs).astype(jnp.int32)
    valid = (c >= 0) & (c < nx) & (r >= 0) & (r < ny)
    rr = jnp.where(valid, r, 0)
    cc = jnp.where(valid, c, 0)
    ident = -jnp.inf if bin_type == "max" else jnp.inf
    zv = jnp.where(valid, z, ident)
    if bin_type == "max":
        return grid.at[rr, cc].max(zv, mode="drop")
    return grid.at[rr, cc].min(zv, mode="drop")


def _sentinel_to_nan(grid, bin_type):
    """Map only the reduction identity (never a legitimate ±inf data
    value) to NaN — matches scatter_reduce's empty-cell convention."""
    empty = (jnp.isneginf(grid) if bin_type == "max"
             else jnp.isposinf(grid))
    return jnp.where(empty, jnp.nan, grid)


def grid_points_device(x, y, z, cellsize=1, bin_type="max", edges=None,
                       method="scatter", chunks=1):
    """End-to-end device gridding: origin-shift on host, then binning
    and reduction on device.  Returns (I, t).

    ``chunks=1`` runs one fused device program.  ``chunks>1`` streams
    the points in equal-size batches: the host origin-shifts chunk
    k+1 while the device scatters chunk k (JAX dispatch is async), so
    the host and device legs overlap and peak host memory is one
    chunk's f32 coordinates instead of the whole cloud.  min/max
    scatter is order-independent, so the streamed grid is bit-identical
    to the fused single-program result.
    """
    if chunks <= 1:
        x_rel, y_rel, (ny, nx), t = bin_points_device(x, y, cellsize,
                                                      edges)
        grid = _grid_fused(jnp.asarray(x_rel), jnp.asarray(y_rel),
                           jnp.asarray(z, dtype=jnp.float32),
                           jnp.float32(1.0 / t.a), ny, nx, bin_type,
                           method)
        return grid, t
    if method != "scatter":
        raise ValueError("chunked streaming requires method='scatter' "
                         "(min/max scatter is order-independent; the "
                         "sort path would re-sort the whole stream)")
    if bin_type not in ("max", "min"):
        raise ValueError("This type not supported.")
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z)
    ny, nx, t, cellsize_, _ = _grid_frame(x, y, cellsize, edges)
    from .binning_native import origin_shift_native
    n = x.size
    ident = -np.inf if bin_type == "max" else np.inf
    grid = jnp.full((ny, nx), np.float32(ident), dtype=jnp.float32)
    inv = jnp.float32(1.0 / t.a)
    size = -(-n // int(chunks))
    for lo in range(0, n, size):
        hi = min(lo + size, n)
        xs, ys = x[lo:hi], y[lo:hi]
        shifted = origin_shift_native(xs, ys, t.c, t.f)
        if shifted is None:
            shifted = ((xs - t.c).astype(np.float32),
                       (t.f - ys).astype(np.float32))
        xr, yr = shifted
        if hi - lo < size:  # pad the tail chunk to the static shape
            pad = size - (hi - lo)
            xr = np.concatenate([xr, np.full(pad, -1.0, np.float32)])
            yr = np.concatenate([yr, np.full(pad, -1.0, np.float32)])
            zc = np.concatenate([np.asarray(z[lo:hi], dtype=np.float32),
                                 np.zeros(pad, np.float32)])
        else:
            zc = np.asarray(z[lo:hi], dtype=np.float32)
        # enqueue and immediately go shift the next chunk — the device
        # consumes this one while the host works
        grid = _grid_scatter_accum(grid, jnp.asarray(xr),
                                   jnp.asarray(yr), jnp.asarray(zc),
                                   inv, ny, nx, bin_type)
    return _sentinel_to_nan(grid, bin_type), t


def create_dem_from_las(filename, cellsize=1, bin_type="max",
                        chunk_points=4_000_000, stride=1, bbox=None,
                        classes=None, edges=None, inpaint=False):
    """Grid a LAS file straight to a DEM in fixed host memory.

    Streams the file through the native decoder in ``chunk_points``
    batches and scatters each batch into the device grid (the same
    order-independent min/max accumulation as
    ``create_dem(..., device_bin=True, chunks=N)``), so an
    arbitrarily large LAS grids in the memory of one chunk.  The grid
    frame comes from the LAS header's min/max block (a spec-mandated
    summary of the actual coordinates), which matches
    ``create_dem``'s point-derived frame whenever the header is
    truthful; pass ``edges`` to pin the frame explicitly.

    ``classes``: optional iterable of ASPRS classification codes to
    keep (e.g. ``(2,)`` for ground-only).  ``bbox`` and ``stride``
    filter/decimate inside the native decoder.  Returns (I, t).

    Extension (no reference equivalent: neilpy users chain
    read_las -> create_dem, neilpy.py:903/1110, materializing the
    whole cloud).
    """
    from ..io.las_native import (native_available, read_header,
                                 read_las_chunks)
    if not native_available():
        # fallback: whole-file python reader + in-memory gridding
        from ..io.las import read_las_columns
        _, df = read_las_columns(filename)
        x, y = df["x"], df["y"]
        sel = np.arange(x.size)
        if bbox is not None:
            sel = sel[(x >= bbox[0]) & (x <= bbox[1])
                      & (y >= bbox[2]) & (y <= bbox[3])]
        sel = sel[::stride]
        if classes is not None:
            sel = sel[np.isin(df["class"][sel],
                              np.asarray(list(classes)))]
        return create_dem(df["x"][sel], df["y"][sel], df["z"][sel],
                          cellsize=cellsize,
                          bin_type=bin_type, edges=edges,
                          inpaint=inpaint, device_bin=True)
    if bin_type not in ("max", "min"):
        raise ValueError("This type not supported.")
    hdr = read_header(filename)
    xmin, xmax, ymin, ymax = (hdr["minmax"][0], hdr["minmax"][1],
                              hdr["minmax"][2], hdr["minmax"][3])
    if bbox is not None:
        xmin, xmax = max(xmin, bbox[0]), min(xmax, bbox[1])
        ymin, ymax = max(ymin, bbox[2]), min(ymax, bbox[3])
    ny, nx, t, cellsize_, _ = _grid_frame(np.array([xmin, xmax]),
                                          np.array([ymin, ymax]),
                                          cellsize, edges)
    from .binning_native import origin_shift_native
    class_arr = (None if classes is None
                 else np.asarray(list(classes), dtype=np.uint8))
    ident = -np.inf if bin_type == "max" else np.inf
    grid = jnp.full((ny, nx), np.float32(ident), dtype=jnp.float32)
    inv = jnp.float32(1.0 / t.a)
    pad_to = -(-min(chunk_points, hdr["num_point_records"]) // stride)
    for chunk in read_las_chunks(filename, chunk_points=chunk_points,
                                 stride=stride, bbox=bbox):
        x, y, z = chunk["x"], chunk["y"], chunk["z"]
        if class_arr is not None:
            keep = np.isin(chunk["class"], class_arr)
            x, y, z = x[keep], y[keep], z[keep]
        if x.size == 0:
            continue
        shifted = origin_shift_native(x, y, t.c, t.f)
        if shifted is None:
            shifted = ((x - t.c).astype(np.float32),
                       (t.f - y).astype(np.float32))
        xr, yr = shifted
        zc = z.astype(np.float32)
        if xr.size < pad_to:  # fixed shape -> one device compile
            pad = pad_to - xr.size
            xr = np.concatenate([xr, np.full(pad, -1.0, np.float32)])
            yr = np.concatenate([yr, np.full(pad, -1.0, np.float32)])
            zc = np.concatenate([zc, np.zeros(pad, np.float32)])
        grid = _grid_scatter_accum(grid, jnp.asarray(xr),
                                   jnp.asarray(yr), jnp.asarray(zc),
                                   inv, ny, nx, bin_type)
    I = _sentinel_to_nan(grid, bin_type)
    if inpaint:
        from .inpaint import inpaint_nans_by_springs
        I = inpaint_nans_by_springs(I)
    return I, t


def create_dem(x, y, z, cellsize=1, bin_type="max", inpaint=False,
               edges=None, use_binned_statistic=False,
               device_bin=False, method="scatter", chunks=1):
    """Scatter-to-grid DEM creation (parity: neilpy.py:1110-1166).

    Returns (I, t): the (ny, nx) float grid with NaN empty cells and the
    affine transform.  ``inpaint=True`` spring-inpaints the gaps.
    ``device_bin=True`` takes the fused on-device binning fast path
    (see ``grid_points_device``); the default is the exact host-f64
    binning the reference's pandas groupby uses.  ``chunks>1`` (with
    ``device_bin=True``) streams the cloud in batches so the host
    origin-shift overlaps the device scatter and peak host memory is
    one batch — same bits out (min/max is order-independent).
    """
    del use_binned_statistic  # scipy fallback not needed on this path
    if device_bin:
        I, t = grid_points_device(x, y, z, cellsize=cellsize,
                                  bin_type=bin_type, edges=edges,
                                  method=method, chunks=chunks)
        if inpaint:
            from .inpaint import inpaint_nans_by_springs
            I = inpaint_nans_by_springs(I)
        return I, t
    z = np.asarray(z, dtype=np.float64)
    flat, valid, (ny, nx), t = bin_points(x, y, cellsize=cellsize,
                                          edges=edges)
    if ny * nx > _INT32_MAX:
        # the flat int64 host index does not fit the device's int32 —
        # split into (row, col) components, each of which does
        if method != "scatter":
            raise ValueError("grids beyond 2**31 cells require "
                             "method='scatter' (the sort path keys on "
                             "a flat int32 index)")
        r = (flat // nx).astype(np.int32)
        c = (flat % nx).astype(np.int32)
        I = _scatter_reduce_rc(r, c, z.astype(np.float32), valid,
                               ny, nx, bin_type)
    else:
        grid = scatter_reduce(flat, z, valid, ny * nx,
                              bin_type=bin_type, method=method)
        I = jnp.reshape(grid, (ny, nx))
    if inpaint:
        from .inpaint import inpaint_nans_by_springs
        I = inpaint_nans_by_springs(I)
    return I, t
