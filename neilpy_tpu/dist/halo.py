"""Halo exchange over a 2-D device mesh — the framework's native
scaling story.

The reference scales big rasters with ``skimage.util.apply_parallel``
(tile-wise map with overlap, SURVEY.md §2.5); the equivalent here is a
2-D ``jax.sharding.Mesh`` with each chip holding one block of the DEM
and stencil kernels running under ``shard_map`` after an explicit halo
exchange sized by the stencil radius.  Collectives ride ICI
(``lax.ppermute`` neighbour pushes), so no host round-trips.

Boundary semantics are preserved *globally*: interior mesh seams
receive real neighbour data; blocks on the mesh boundary fill their
missing halo so that the local kernel reproduces exactly what the
single-device kernel would have produced at the global edge:

* ``mode='symmetric'`` — scipy reflect padding (curvature, morphology)
* ``mode='edge'``      — scipy nearest padding (convolutions)
* ``mode='linear'``    — linear extrapolation ``2 z[e] - z[e-1]``,
  which makes *central* differences at the global edge equal
  ``np.gradient``'s one-sided differences (slope/aspect/hillshade)
* ``mode='zero'`` / ``'nan'`` — constant fill (kernels that mask by
  global coordinates themselves, e.g. the openness scan)

Corner halos come for free from the standard two-phase exchange:
columns first, then rows of the column-padded block.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = ["halo_exchange_2d", "sharded_apply", "block_origin"]


def _exchange_axis(block, radius, axis_name, n_shards, axis):
    """Pad ``block`` along array axis ``axis`` with ``radius``
    rows/cols exchanged from mesh neighbours along ``axis_name``.
    Out-of-mesh halos are zero-filled (fixed up by the caller).

    When ``radius`` exceeds the per-device block extent the exchange
    runs MULTI-HOP: whole blocks are forwarded neighbour-to-neighbour
    ``ceil(radius / extent)`` times (``ppermute`` chains over ICI), and
    the halo is assembled from as many full blocks as needed plus a
    partial slice of the farthest one.  Devices whose chain walks off
    the mesh receive ppermute's zero fill, matching the single-hop
    convention."""
    if radius == 0:
        return block
    bs = block.shape[axis]
    take = lambda a, sl: a[sl] if axis == 0 else a[:, sl]
    if n_shards == 1:
        shape = list(block.shape)
        shape[axis] = radius  # NOT a block slice: radius may exceed bs
        z = jnp.zeros(shape, dtype=block.dtype)
        return jnp.concatenate([z, block, z], axis=axis)
    if radius <= bs:
        lead = take(block, slice(0, radius))
        tail = take(block, slice(bs - radius, None))
        # neighbour i+1's leading strip becomes my trailing halo
        from_next = lax.ppermute(lead, axis_name,
                                 [(i, i - 1) for i in range(1, n_shards)])
        from_prev = lax.ppermute(tail, axis_name,
                                 [(i, i + 1) for i in range(n_shards - 1)])
        return jnp.concatenate([from_prev, block, from_next], axis=axis)

    # multi-hop: forward full blocks h times -> block of device i -+ h
    hops = -(-radius // bs)
    prev_chain = []
    next_chain = []
    prev = block
    nxt = block
    for _ in range(hops):
        prev = lax.ppermute(prev, axis_name,
                            [(i, i + 1) for i in range(n_shards - 1)])
        nxt = lax.ppermute(nxt, axis_name,
                           [(i, i - 1) for i in range(1, n_shards)])
        prev_chain.append(prev)   # device i - h's block
        next_chain.append(nxt)    # device i + h's block
    part = radius - (hops - 1) * bs  # rows taken from the farthest block
    lead_parts = [take(prev_chain[-1], slice(bs - part, None))]
    lead_parts += [prev_chain[h] for h in range(hops - 2, -1, -1)]
    tail_parts = [next_chain[h] for h in range(hops - 1)]
    tail_parts += [take(next_chain[-1], slice(0, part))]
    return jnp.concatenate(lead_parts + [block] + tail_parts, axis=axis)


def _boundary_fill(padded, radius, axis, at_start, at_end, mode):
    """Overwrite the out-of-mesh halo region with the requested global
    boundary semantics, selected per-block by mesh position."""
    if radius == 0 or mode == "none":
        return padded
    n = padded.shape[axis]

    def region(sl):
        return sl if axis == 0 else (slice(None), sl)

    core_first = radius            # first core index
    core_last = n - radius - 1     # last core index

    if mode in ("symmetric", "edge", "linear"):
        idx = [None] * (radius)
        fill_start = []
        fill_end = []
        for k in range(radius):
            # halo position k (0 = outermost) at the start side
            if mode == "symmetric":
                src_s = core_first + (radius - 1 - k)
                src_e = core_last - (radius - 1 - k)
                fs = lax.index_in_dim(padded, src_s, axis, keepdims=True)
                fe = lax.index_in_dim(padded, src_e, axis, keepdims=True)
            elif mode == "edge":
                fs = lax.index_in_dim(padded, core_first, axis,
                                      keepdims=True)
                fe = lax.index_in_dim(padded, core_last, axis,
                                      keepdims=True)
            else:  # linear: z[e - d] extrapolated to z[e] + d*(z[e]-z[e-1])
                d = radius - k
                e0 = lax.index_in_dim(padded, core_first, axis,
                                      keepdims=True)
                e1 = lax.index_in_dim(padded, core_first + 1, axis,
                                      keepdims=True)
                fs = e0 + d * (e0 - e1)
                f0 = lax.index_in_dim(padded, core_last, axis,
                                      keepdims=True)
                f1 = lax.index_in_dim(padded, core_last - 1, axis,
                                      keepdims=True)
                fe = f0 + d * (f0 - f1)
            fill_start.append(fs)
            fill_end.append(fe)
        fill_start = jnp.concatenate(fill_start, axis=axis)
        fill_end = jnp.concatenate(fill_end, axis=axis)
    elif mode == "zero":
        shape = list(padded.shape)
        shape[axis] = radius
        fill_start = fill_end = jnp.zeros(shape, dtype=padded.dtype)
    elif mode == "nan":
        shape = list(padded.shape)
        shape[axis] = radius
        fill_start = fill_end = jnp.full(shape, jnp.nan,
                                         dtype=padded.dtype)
    else:
        raise ValueError(f"unknown halo mode {mode}")

    head = padded[region(slice(0, radius))]
    tail = padded[region(slice(n - radius, None))]
    head = jnp.where(at_start, fill_start, head)
    tail = jnp.where(at_end, fill_end, tail)
    core = padded[region(slice(radius, n - radius))]
    return jnp.concatenate([head, core, tail], axis=axis)


def _beyond_mesh_fill(padded, radius, axis, dev_idx, bs, n_shards,
                      mode):
    """Coordinate-based fill for multi-hop halos: positions whose
    global index falls off the mesh get the constant fill (they arrive
    as ppermute zeros; 'nan' mode rewrites them)."""
    if mode == "zero":
        return padded  # truncated ppermute chains already deliver 0
    n = padded.shape[axis]
    idx = lax.broadcasted_iota(jnp.int32, padded.shape, axis)
    glob = idx - radius + dev_idx * bs
    beyond = (glob < 0) | (glob >= n_shards * bs)
    return jnp.where(beyond, jnp.nan, padded)


def halo_exchange_2d(block, radius, axis_names=("ty", "tx"),
                     mesh_shape=None, mode="symmetric"):
    """Exchange halos of width ``radius`` with mesh neighbours along
    two named mesh axes; fill global-boundary halos per ``mode``.

    Must be called inside ``shard_map`` over a mesh with the given axis
    names.  ``mesh_shape`` (ny, nx) is required (static).

    ``radius`` may exceed the per-device block extent: the exchange
    then runs multi-hop (see ``_exchange_axis``).  Multi-hop supports
    the constant fills ('zero'/'nan' — the long-range stencils'
    modes); reflect-family fills would need mesh-global mirroring and
    raise instead.
    """
    ny, nx = mesh_shape
    iy = lax.axis_index(axis_names[0])
    ix = lax.axis_index(axis_names[1])
    bh, bw = block.shape

    multi_col = nx > 1 and radius > bw
    multi_row = ny > 1 and radius > bh
    if (multi_col or multi_row) and mode not in ("zero", "nan", "none"):
        raise ValueError(
            f"halo radius {radius} exceeds the per-device block "
            f"{block.shape} and mode={mode!r} cannot be reconstructed "
            "multi-hop; use mode 'zero'/'nan' or fewer shards")

    # columns first, then rows of the column-padded block -> corners OK
    p = _exchange_axis(block, radius, axis_names[1], nx, axis=1)
    if multi_col:
        p = _beyond_mesh_fill(p, radius, 1, ix, bw, nx, mode)
    else:
        p = _boundary_fill(p, radius, 1, ix == 0, ix == nx - 1, mode)
    p = _exchange_axis(p, radius, axis_names[0], ny, axis=0)
    if multi_row:
        p = _beyond_mesh_fill(p, radius, 0, iy, bh, ny, mode)
    else:
        p = _boundary_fill(p, radius, 0, iy == 0, iy == ny - 1, mode)
    return p


def block_origin(block_shape, axis_names=("ty", "tx")):
    """Global (row, col) origin of this block (traced ints)."""
    iy = lax.axis_index(axis_names[0])
    ix = lax.axis_index(axis_names[1])
    return iy * block_shape[0], ix * block_shape[1]


def sharded_apply(fn, Z, mesh, radius, mode="symmetric",
                  axis_names=("ty", "tx")):
    """Run ``fn(padded_block) -> padded_or_core_block`` over a 2-D mesh
    with halo exchange, reassembling the global result.

    ``fn`` receives a block padded by ``radius`` on every side and must
    return either the same padded shape (cropped here) or the core
    block.  The wrapper handles sharding of input/output.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    H, W = Z.shape
    assert H % ny == 0 and W % nx == 0, (
        f"grid {Z.shape} not divisible by mesh {ny}x{nx}; pad first")
    bh, bw = H // ny, W // nx

    def local(block):
        padded = halo_exchange_2d(block, radius, axis_names,
                                  (ny, nx), mode)
        out = fn(padded)
        if out.shape[-2:] == (bh + 2 * radius, bw + 2 * radius):
            out = out[..., radius:radius + bh, radius:radius + bw]
        return out

    spec = P(*axis_names)
    sharded = shard_map(local, mesh=mesh, in_specs=(spec,),
                        out_specs=spec)
    Zs = jax.device_put(jnp.asarray(Z, dtype=jnp.float32),
                        NamedSharding(mesh, spec))
    return sharded(Zs)
