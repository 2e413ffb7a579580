"""Sharded (multi-chip) raster pipelines over a 2-D device mesh.

This replaces the reference's
``apply_parallel(func, Z, tile_size, overlap)`` tiling
(test_neilpy.py:45, SURVEY.md §2.5): the DEM lives sharded across the
mesh, stencils run under ``shard_map`` after a halo exchange sized
by the stencil radius, and outputs stay sharded for downstream stages.
The tiled==untiled property the reference trusted ``apply_parallel``
to preserve is asserted by the test suite on a virtual CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .halo import halo_exchange_2d, block_origin
from ..backend import resolve_engine
from ..ops.visibility import (directional_ratio_extrema,
                              _angles_from_extrema, classes_from_counts)

__all__ = ["make_mesh", "sharded_geomorphons", "sharded_openness",
           "sharded_skyview", "sharded_rastergi",
           "sharded_local_morans_i", "sharded_morans_i",
           "sharded_hillshade", "pad_to_mesh", "sharded_apply"]

from .halo import sharded_apply  # re-export


def make_mesh(devices=None, shape=None, axis_names=("ty", "tx")):
    """Build a 2-D mesh from the available devices (factored as close
    to square as possible unless ``shape`` is given)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        ny = int(np.floor(np.sqrt(n)))
        while n % ny:
            ny -= 1
        shape = (ny, n // ny)
    devs = np.asarray(devices[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, axis_names)


def pad_to_mesh(Z, mesh, axis_names=("ty", "tx"), fill=jnp.nan):
    """Pad a raster on the bottom/right so both dims divide the mesh.
    Returns (padded, original_shape)."""
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    H, W = Z.shape
    Hp = -(-H // ny) * ny
    Wp = -(-W // nx) * nx
    if (Hp, Wp) != (H, W):
        Z = jnp.pad(jnp.asarray(Z), ((0, Hp - H), (0, Wp - W)),
                    constant_values=fill)
    return Z, (H, W)


@partial(jax.jit, static_argnames=("mesh", "lookup_pixels", "axis_names",
                                   "global_shape", "engine", "cellsize",
                                   "threshold_angle", "fast", "how_fast"))
def _sharded_counts(Zs, mesh, cellsize, lookup_pixels, threshold_angle,
                    global_shape, axis_names=("ty", "tx"),
                    engine="xla", fast=False, how_fast=20):
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    bh = global_shape[0] // ny
    bw = global_shape[1] // nx
    r = int(lookup_pixels)

    def local(block):
        oy, ox = block_origin((bh, bw), axis_names)
        if engine == "pallas":
            # NaN halo beyond mesh == beyond raster: the kernel skips
            # NaNs and applies the global edge-replication correction
            # from (origin, global_shape)
            from ..ops.pallas_scan import openness_counts_pallas_block
            padded = halo_exchange_2d(block, r, axis_names, (ny, nx),
                                      mode="nan")
            return openness_counts_pallas_block(
                padded, (oy, ox), global_shape, r, cellsize=cellsize,
                threshold_angle=threshold_angle, vma=axis_names,
                fast=fast, how_fast=how_fast)
        # NaN halo beyond the mesh, like the Pallas branch: the blocked
        # scan skips NaN reads and restores the global edge-replication
        # contribution from (origin, global_shape)
        padded = halo_exchange_2d(block, r, axis_names, (ny, nx),
                                  mode="nan")
        mx, mn, seen = directional_ratio_extrema(
            padded, cellsize=cellsize, lookup_pixels=r,
            origin=(oy - r, ox - r), global_shape=global_shape,
            fast=fast, how_fast=how_fast)
        pos = jnp.rad2deg(_angles_from_extrema(mx, seen))
        neg = jnp.rad2deg(_angles_from_extrema(-mn, seen))
        diff = pos - neg
        t = jnp.float32(threshold_angle)
        num_pos = jnp.sum(diff > t, axis=0).astype(jnp.uint8)
        num_neg = jnp.sum(diff < -t, axis=0).astype(jnp.uint8)
        return (num_pos[r:r + bh, r:r + bw], num_neg[r:r + bh, r:r + bw])

    spec = P(*axis_names)
    # check_vma=False: the interpreted pallas_call mixes varying and
    # unvarying operands in a dynamic_slice, which the vma checker
    # cannot type yet (it suggests this workaround itself)
    return shard_map(local, mesh=mesh, in_specs=(spec,),
                     out_specs=(spec, spec), check_vma=False)(Zs)


def sharded_geomorphons(Z, mesh=None, cellsize=1, lookup_pixels=1,
                        threshold_angle=1, axis_names=("ty", "tx"),
                        engine="auto", fast=False, how_fast=20):
    """Geomorphon classification sharded over a device mesh — the
    multi-chip analog of ``geomorphons`` (bit-identical to the
    single-device kernel; asserted in tests).

    ``engine='auto'`` uses the Pallas ladder kernel per shard on the
    GPU (halo exchange feeds it real neighbour data), the XLA scan
    otherwise.
    """
    if mesh is None:
        mesh = make_mesh()
    engine = resolve_engine(engine)
    Zp, orig = pad_to_mesh(jnp.asarray(Z, dtype=jnp.float32), mesh,
                           axis_names)
    spec = P(*axis_names)
    Zs = jax.device_put(Zp, NamedSharding(mesh, spec))
    num_pos, num_neg = _sharded_counts(
        Zs, mesh, float(cellsize), int(lookup_pixels),
        float(threshold_angle), tuple(Zp.shape), axis_names, engine,
        fast=bool(fast), how_fast=int(how_fast))
    G = classes_from_counts(num_pos, num_neg)
    return G[: orig[0], : orig[1]]


def _sharded_extrema_map(Z, mesh, cellsize, lookup_pixels, axis_names,
                         epilogue):
    """Shared scaffold for mesh-sharded extrema consumers: pad to the
    mesh, halo-exchange each block, run the ratio-extrema scan with a
    global origin, and crop ``epilogue(mx, seen) -> (H, W)`` back to
    the original shape."""
    if mesh is None:
        mesh = make_mesh()
    Zp, orig = pad_to_mesh(jnp.asarray(Z, dtype=jnp.float32), mesh,
                           axis_names)
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    bh, bw = Zp.shape[0] // ny, Zp.shape[1] // nx
    r = int(lookup_pixels)
    gshape = tuple(Zp.shape)

    def local(block):
        oy, ox = block_origin((bh, bw), axis_names)
        padded = halo_exchange_2d(block, r, axis_names, (ny, nx),
                                  mode="nan")
        mx, _, seen = directional_ratio_extrema(
            padded, cellsize=jnp.float32(cellsize), lookup_pixels=r,
            origin=(oy - r, ox - r), global_shape=gshape)
        out = epilogue(mx, seen)
        return out[r:r + bh, r:r + bw]

    spec = P(*axis_names)
    Zs = jax.device_put(Zp, NamedSharding(mesh, spec))
    out = shard_map(local, mesh=mesh, in_specs=(spec,),
                    out_specs=spec)(Zs)
    return out[: orig[0], : orig[1]]


def sharded_openness(Z, mesh=None, cellsize=1, lookup_pixels=1,
                     axis_names=("ty", "tx")):
    """Positive openness sharded over a device mesh."""
    return _sharded_extrema_map(
        Z, mesh, cellsize, lookup_pixels, axis_names,
        lambda mx, seen: jnp.rad2deg(
            jnp.mean(_angles_from_extrema(mx, seen), axis=0)))


def sharded_skyview(Z, mesh=None, cellsize=1, lookup_pixels=1,
                    axis_names=("ty", "tx")):
    """Skyview factor sharded over a device mesh — the same
    ratio-extrema reformulation as ``skyview_factor`` (reference
    neilpy.py:1360-1384).  The clip at 0 absorbs both boundary-zero
    and never-seen contributions, so the sharded result equals the
    single-device kernel."""
    from ..ops.visibility import svf_from_extrema
    return _sharded_extrema_map(Z, mesh, cellsize, lookup_pixels,
                                axis_names,
                                lambda mx, seen: svf_from_extrema(mx))


def _footprint_array(footprint, star):
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=bool)
        if not star:
            fp[m, m] = False
    else:
        fp = np.asarray(footprint) != 0
        star = bool(fp[fp.shape[0] // 2, fp.shape[1] // 2])
    return fp, star


def sharded_rastergi(Z, footprint=1, mesh=None, star=False,
                     apply_correction=False, axis_names=("ty", "tx")):
    """Getis-Ord Gi/Gi* hotspot raster over a 2-D device mesh.

    Same math as ``ops.stats.rasterGi`` (mode='nearest'): global
    moments ride ``psum`` over the mesh, neighbourhood counts/sums run
    on halo-exchanged blocks, and the optional ArcGIS correction
    z-scores against psum'd statistics of the sharded Z map.  Sharded
    == single-device is asserted by tests/test_dist.py.
    """
    from jax import lax
    from ..ops.surface import binary_footprint_sum
    from ..ops.stats import _norm_sf
    if mesh is None:
        mesh = make_mesh()
    fp, star = _footprint_array(footprint, star)
    r = max(fp.shape) // 2
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    # NaN mesh padding for the global moments (excluded naturally);
    # edge-replicated padding for the neighbourhood sums so the
    # remainder rows/cols continue scipy's 'nearest' boundary rule
    # (the outermost halo ring then replicates the same values)
    Zp, orig = pad_to_mesh(jnp.asarray(Z, dtype=jnp.float32), mesh,
                           axis_names, fill=jnp.nan)
    Ze = jnp.asarray(np.pad(np.asarray(Z, dtype=np.float32),
                            ((0, Zp.shape[0] - orig[0]),
                             (0, Zp.shape[1] - orig[1])), mode="edge"))
    bh, bw = Zp.shape[0] // ny, Zp.shape[1] // nx

    def local(block, eblock):
        finite = jnp.isfinite(block)
        x0 = jnp.where(finite, block, 0.0)
        nf = lax.psum(jnp.sum(finite.astype(jnp.float32)), axis_names)
        tot = lax.psum(jnp.sum(x0), axis_names)
        tot2 = lax.psum(jnp.sum(x0 * x0), axis_names)
        if star:
            gm = tot / nf
            gv = tot2 / nf - gm ** 2
        else:
            gm = (tot - block) / (nf - 1)
            gv = ((tot2 - block ** 2) / (nf - 1)) - gm ** 2
            gm = jnp.where(finite, gm, jnp.nan)
            gv = jnp.where(finite, gv, jnp.nan)
        padded = halo_exchange_2d(eblock, r, axis_names, (ny, nx),
                                  mode="edge")
        pfin = jnp.isfinite(padded)
        w = binary_footprint_sum(pfin.astype(jnp.float32), fp,
                                 mode="nearest")
        s = binary_footprint_sum(jnp.where(pfin, padded, 0.0), fp,
                                 mode="nearest")
        w = jnp.round(w[r:r + bh, r:r + bw])
        s = s[r:r + bh, r:r + bw]
        w = jnp.where(finite, w, jnp.nan)
        a = s - w * gm
        if star:
            b = jnp.sqrt((w / (nf - 1)) * (nf - w) * gv)
        else:
            b = jnp.sqrt((w / (nf - 2)) * (nf - 1 - w) * gv)
        Zs = jnp.where(finite, a / b, jnp.nan)
        if apply_correction:
            zf = jnp.isfinite(Zs)
            z0 = jnp.where(zf, Zs, 0.0)
            zn = lax.psum(jnp.sum(zf.astype(jnp.float32)), axis_names)
            zs = lax.psum(jnp.sum(z0), axis_names)
            zs2 = lax.psum(jnp.sum(z0 * z0), axis_names)
            zm = zs / zn
            zstd = jnp.sqrt(zs2 / zn - zm ** 2)
            Zs = (Zs - zm) / zstd
        P = 2.0 * _norm_sf(jnp.abs(Zs))
        sig = jnp.zeros_like(block)
        sig = jnp.where(P < .1, 1.0, sig)
        sig = jnp.where(P < .05, 2.0, sig)
        sig = jnp.where(P < .01, 3.0, sig)
        sig = jnp.where(Zs < 0, -sig, sig)
        sig = jnp.where(P >= .1, 0.0, sig)
        sig = jnp.where(finite, sig, jnp.nan)
        return jnp.stack([Zs, P, sig])

    spec = P(*axis_names)
    out_spec = P(None, *axis_names)
    sharded = shard_map(local, mesh=mesh, in_specs=(spec, spec),
                        out_specs=out_spec)
    sh = NamedSharding(mesh, spec)
    out = sharded(jax.device_put(Zp, sh), jax.device_put(Ze, sh))
    return (out[0, : orig[0], : orig[1]],
            out[1, : orig[0], : orig[1]],
            out[2, : orig[0], : orig[1]])


def sharded_morans_i(Z, footprint=1, mesh=None,
                     axis_names=("ty", "tx")):
    """Global Moran's I over a 2-D device mesh: every reduction
    (finite count, mean, lag cross-product, weight totals, the
    Cliff & Ord S2 term) rides ``psum``; neighbourhood sums run on
    halo-exchanged blocks.  Returns the replicated ``(I, E_I, z)``
    scalar triple of ``ops.stats.morans_i`` (mode='nearest')."""
    from jax import lax
    from ..ops.surface import binary_footprint_sum
    if mesh is None:
        mesh = make_mesh()
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=bool)
        fp[m, m] = False
    else:
        fp = np.asarray(footprint) != 0
        fp = fp.copy()
        fp[fp.shape[0] // 2, fp.shape[1] // 2] = False
    r = max(fp.shape) // 2
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    Zp, orig = pad_to_mesh(jnp.asarray(Z, dtype=jnp.float32), mesh,
                           axis_names, fill=jnp.nan)
    Ze = jnp.asarray(np.pad(np.asarray(Z, dtype=np.float32),
                            ((0, Zp.shape[0] - orig[0]),
                             (0, Zp.shape[1] - orig[1])), mode="edge"))
    bh, bw = Zp.shape[0] // ny, Zp.shape[1] // nx

    def local(block, eblock):
        finite = jnp.isfinite(block)
        x0 = jnp.where(finite, block, 0.0)
        nf = lax.psum(jnp.sum(finite.astype(jnp.float32)), axis_names)
        xbar = lax.psum(jnp.sum(x0), axis_names) / nf
        zdev = jnp.where(finite, block - xbar, 0.0)
        padded = halo_exchange_2d(eblock, r, axis_names, (ny, nx),
                                  mode="edge")
        pfin = jnp.isfinite(padded)
        pdev = jnp.where(pfin, padded - xbar, 0.0)
        lag = binary_footprint_sum(pdev, fp,
                                   mode="nearest")[r:r + bh, r:r + bw]
        wmap = binary_footprint_sum(pfin.astype(jnp.float32), fp,
                                    mode="nearest")[r:r + bh, r:r + bw]
        wmap = jnp.round(wmap)
        num = lax.psum(jnp.sum(zdev * lag), axis_names)
        den = lax.psum(jnp.sum(zdev ** 2), axis_names)
        W = lax.psum(jnp.sum(jnp.where(finite, wmap, 0.0)), axis_names)
        S2 = lax.psum(jnp.sum(jnp.where(finite, (2.0 * wmap) ** 2, 0.0)),
                      axis_names)
        I = (nf / W) * (num / den)
        E_I = -1.0 / (nf - 1.0)
        S0, S1 = W, 2.0 * W
        var_I = ((nf ** 2 * S1 - nf * S2 + 3.0 * S0 ** 2)
                 / ((nf ** 2 - 1.0) * S0 ** 2)) - E_I ** 2
        return I, E_I, (I - E_I) / jnp.sqrt(var_I)

    spec = P(*axis_names)
    sharded = shard_map(local, mesh=mesh, in_specs=(spec, spec),
                        out_specs=(P(), P(), P()))
    sh = NamedSharding(mesh, spec)
    return sharded(jax.device_put(Zp, sh), jax.device_put(Ze, sh))


def sharded_local_morans_i(Z, footprint=1, mesh=None,
                           axis_names=("ty", "tx")):
    """Local Moran's I (Anselin LISA) over a 2-D device mesh; global
    moments via ``psum``, lag sums on halo-exchanged blocks.  Matches
    ``ops.stats.local_morans_i`` (mode='nearest')."""
    from jax import lax
    from ..ops.surface import binary_footprint_sum
    if mesh is None:
        mesh = make_mesh()
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=bool)
        fp[m, m] = False
    else:
        fp = np.asarray(footprint) != 0
    r = max(fp.shape) // 2
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    Zp, orig = pad_to_mesh(jnp.asarray(Z, dtype=jnp.float32), mesh,
                           axis_names, fill=jnp.nan)
    Ze = jnp.asarray(np.pad(np.asarray(Z, dtype=np.float32),
                            ((0, Zp.shape[0] - orig[0]),
                             (0, Zp.shape[1] - orig[1])), mode="edge"))
    bh, bw = Zp.shape[0] // ny, Zp.shape[1] // nx

    def local(block, eblock):
        finite = jnp.isfinite(block)
        x0 = jnp.where(finite, block, 0.0)
        nf = lax.psum(jnp.sum(finite.astype(jnp.float32)), axis_names)
        tot = lax.psum(jnp.sum(x0), axis_names)
        xbar = tot / nf
        zdev = jnp.where(finite, block - xbar, 0.0)
        s2 = lax.psum(jnp.sum(zdev ** 2), axis_names) / nf
        padded = halo_exchange_2d(eblock, r, axis_names, (ny, nx),
                                  mode="edge")
        pdev = jnp.where(jnp.isfinite(padded), padded - xbar, 0.0)
        lag = binary_footprint_sum(pdev, fp, mode="nearest")
        lag = lag[r:r + bh, r:r + bw]
        return jnp.where(finite, (zdev / s2) * lag, jnp.nan)

    spec = P(*axis_names)
    sharded = shard_map(local, mesh=mesh, in_specs=(spec, spec),
                        out_specs=spec)
    sh = NamedSharding(mesh, spec)
    return sharded(jax.device_put(Zp, sh),
                   jax.device_put(Ze, sh))[: orig[0], : orig[1]]


def sharded_hillshade(Z, mesh=None, cellsize=1, z_factor=1, zenith=45,
                      azimuth=315, axis_names=("ty", "tx")):
    """Hillshade sharded over a device mesh.  Radius-1 halo with linear
    extrapolation reproduces np.gradient's one-sided edge differences
    at the global boundary exactly."""
    from ..ops.surface import hillshade
    if mesh is None:
        mesh = make_mesh()
    from .halo import sharded_apply as _apply
    Zp, orig = pad_to_mesh(jnp.asarray(Z, dtype=jnp.float32), mesh,
                           axis_names, fill=0.0)
    out = _apply(lambda b: hillshade(b, cellsize=cellsize,
                                     z_factor=z_factor, zenith=zenith,
                                     azimuth=azimuth),
                 Zp, mesh, radius=1, mode="linear",
                 axis_names=axis_names)
    return out[: orig[0], : orig[1]]
