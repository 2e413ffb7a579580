"""SMRF — the Simple Morphological Filter (Pingel, Clarke & McBride
2013) for lidar ground/object classification.

Reference call stack (SURVEY.md §3.1; neilpy/neilpy.py:1659-1808):
``create_dem(min)`` -> spring inpaint -> low-outlier pass ->
progressive morphological opening ladder -> inpaint provisional DTM ->
bicubic spline lift back to points -> slope-adaptive threshold.

Composition: host does only the f64 bin-index math; the
minimum-surface scatter, both Laplacian inpaints, the whole opening
ladder (disk kernels from ops/morphology), the gradient slope and the
bicubic point lift all run as jitted device programs.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from ..ops.pointgrid import create_dem
from ..ops.inpaint import springs_fill
from ..ops.morphology import _disk_morph
from ..ops.spline import spline_coefficients_2d, spline_ev_2d
from ..core.shift import gradient2d

__all__ = ["progressive_filter", "smrf", "smrf_las"]


@partial(jax.jit, static_argnames=("windows", "return_when_dropped"))
def _progressive_ladder(Z, windows, thresholds, return_when_dropped):
    """The whole opening ladder fused into ONE jitted program (one
    compile instead of one per radius)."""
    last_surface = Z
    is_object = jnp.zeros(Z.shape, dtype=bool)
    when_dropped = jnp.zeros(Z.shape, dtype=jnp.uint8)
    for i, window in enumerate(windows):
        opened = _disk_morph(_disk_morph(last_surface, window,
                                         jnp.minimum),
                             window, jnp.maximum)
        new_obj = (last_surface - opened) > thresholds[i]
        is_object = is_object | new_obj
        if return_when_dropped:
            when_dropped = jnp.where(new_obj, jnp.uint8(i), when_dropped)
        last_surface = opened
    return is_object, when_dropped


def progressive_filter(Z, windows, cellsize=1, slope_threshold=.15,
                       return_when_dropped=False):
    """Progressive morphological opening ladder (parity:
    neilpy.py:1659-1681).

    For each window radius w: grey-open the cascaded surface with
    ``disk(w)`` and flag cells dropping more than
    ``slope_threshold * w * cellsize`` as objects.  Note the reference
    computes (and ignores) a 3x3 override for w==1 — actual behaviour
    is ``opening(disk(w))`` for every w, which is what we replicate.
    """
    windows = np.atleast_1d(np.asarray(windows))
    Z = jnp.asarray(Z, dtype=jnp.float32)
    thresholds = jnp.asarray(slope_threshold * (windows * cellsize),
                             dtype=jnp.float32)
    is_object, when_dropped = _progressive_ladder(
        Z, tuple(int(w) for w in windows), thresholds,
        bool(return_when_dropped))
    if return_when_dropped:
        return is_object, when_dropped
    return is_object


@partial(jax.jit, static_argnames=("windows", "cellsize",
                                   "low_outlier_fill", "return_extras",
                                   "inpaint_tol", "inpaint_maxiter"))
def _smrf_raster(Zmin_raw, windows, thresholds, low_threshold, cellsize,
                 low_outlier_fill, return_extras, inpaint_tol=1e-7,
                 inpaint_maxiter=4000):
    """All grid-shaped SMRF stages fused into ONE device program:
    spring inpaint -> low-outlier opening -> progressive ladder ->
    provisional-DTM inpaint -> spline coefficient construction for the
    DTM and its slope.  One compile serves the whole raster phase."""
    is_empty_cell = jnp.isnan(Zmin_raw)
    Zmin = springs_fill(Zmin_raw, tol=inpaint_tol, maxiter=inpaint_maxiter)

    neg = -Zmin
    opened = _disk_morph(_disk_morph(neg, 1, jnp.minimum), 1, jnp.maximum)
    low_outliers = (neg - opened) > low_threshold

    if low_outlier_fill:
        Zmin = springs_fill(jnp.where(low_outliers, jnp.nan, Zmin),
                            tol=inpaint_tol, maxiter=inpaint_maxiter)

    last_surface = Zmin
    object_cells = jnp.zeros(Zmin.shape, dtype=bool)
    when_dropped = jnp.zeros(Zmin.shape, dtype=jnp.uint8)
    for i, window in enumerate(windows):
        opened = _disk_morph(_disk_morph(last_surface, window,
                                         jnp.minimum),
                             window, jnp.maximum)
        new_obj = (last_surface - opened) > thresholds[i]
        object_cells = object_cells | new_obj
        if return_extras:
            when_dropped = jnp.where(new_obj, jnp.uint8(i), when_dropped)
        last_surface = opened

    object_cells = is_empty_cell | low_outliers | object_cells
    Zpro = springs_fill(jnp.where(object_cells, jnp.nan, Zmin),
                        tol=inpaint_tol, maxiter=inpaint_maxiter)

    coeffs_Z = spline_coefficients_2d(Zpro)
    gy, gx = gradient2d(Zpro, cellsize)
    coeffs_S = spline_coefficients_2d(jnp.sqrt(gy ** 2 + gx ** 2))
    return Zpro, object_cells, when_dropped, coeffs_Z, coeffs_S


@jax.jit
def _smrf_points(coeffs_Z, coeffs_S, r, c, z, elevation_threshold,
                 elevation_scaler):
    """Point-shaped SMRF tail in one program: bicubic lift of the DTM
    and slope surfaces onto the points + the adaptive threshold test
    (reference: neilpy.py:1768-1795)."""
    elevation_values = spline_ev_2d(coeffs_Z, r, c, offset=0.5)
    slope_values = spline_ev_2d(coeffs_S, r, c, offset=0.5)
    required_value = elevation_threshold + elevation_scaler * slope_values
    is_object_point = jnp.abs(elevation_values - z) > required_value
    return is_object_point, elevation_values


def _smrf_points_streamed(coeffs_Z, coeffs_S, r, c, z,
                          elevation_threshold, elevation_scaler,
                          chunk_points, need_elev=True):
    """Chunk-streamed point phase: the classification is element-wise
    per point, so the array splits into fixed-shape chunks that share
    ONE compile (the tail chunk is padded), each dispatched as soon as
    its host->device transfer lands.  The chunk results stay ON DEVICE
    and concatenate there — the earlier version read every chunk back
    to host and re-uploaded the concatenation (~45 MB of pointless
    round-trip for a 5M-point tile).  The
    elevation plane is only assembled when the caller wants extras
    (``need_elev``); skipping it drops another 20 MB/5M pts of device
    traffic.  Labels are bit-identical to the single-call path."""
    n = r.size
    chunk = int(min(chunk_points, max(n, 1)))
    eth = jnp.float32(elevation_threshold)
    esc = jnp.float32(elevation_scaler)
    pending = []  # (device refs, valid length)
    for i in range(0, n, chunk):
        rr = np.asarray(r[i:i + chunk], dtype=np.float32)
        cc = np.asarray(c[i:i + chunk], dtype=np.float32)
        zz = np.asarray(z[i:i + chunk], dtype=np.float32)
        m = rr.size
        if m < chunk:  # pad the tail chunk -> same compiled program
            pad = chunk - m
            rr = np.concatenate([rr, np.zeros(pad, np.float32)])
            cc = np.concatenate([cc, np.zeros(pad, np.float32)])
            zz = np.concatenate([zz, np.zeros(pad, np.float32)])
        pending.append((_smrf_points(coeffs_Z, coeffs_S,
                                     jnp.asarray(rr), jnp.asarray(cc),
                                     jnp.asarray(zz), eth, esc), m))
    is_obj = jnp.concatenate([o[0][:m] for o, m in pending])
    elev = (jnp.concatenate([o[1][:m] for o, m in pending])
            if need_elev else None)
    return is_obj, elev


def smrf(x, y, z, cellsize=1, windows=5, slope_threshold=.15,
         elevation_threshold=.5, elevation_scaler=1.25,
         low_filter_slope=5, low_outlier_fill=False, return_extras=False,
         precision="fast", chunk_points=2_000_000):
    """Simple Morphological Filter (parity: neilpy.py:1685-1808).

    Returns (Zpro, t, object_cells, is_object_point[, extras]):
    provisional DTM, affine transform, boolean object grid, and the
    per-point object classification.

    ``precision='fast'`` (default) runs as exactly three device
    programs: the gridding scatter, the fused raster stage, and the
    fused point stage — all f32 on the accelerator.  Clouds larger
    than ``chunk_points`` stream the point stage in fixed-shape
    chunks (one compile; every chunk dispatched before any readback
    so transfer overlaps compute — the same machinery ``smrf_las``
    uses for whole files), bit-identical to the one-shot call.

    ``precision='exact'`` reruns the same jitted pipeline in float64 on
    the CPU backend (f64 host scatter, CG inpaint at tol=1e-12, f64
    opening ladder and spline), matching the reference's f64 numpy/
    scipy numerics bit-for-bit on the object masks and point labels
    (the BASELINE "bit-matched SMRF masks" target; reference decision
    points neilpy.py:1676, 1794-1795).  The f32 fast path agrees with
    it on >=99.9% of points; 'exact' exists for when the masks are the
    product.
    """
    if precision not in ("fast", "exact"):
        raise ValueError("precision must be 'fast' or 'exact'")
    if np.isscalar(windows):
        windows = np.arange(windows) + 1
    windows = np.atleast_1d(np.asarray(windows))

    if precision == "exact":
        return _smrf_exact(x, y, z, cellsize, windows, slope_threshold,
                           elevation_threshold, elevation_scaler,
                           low_filter_slope, low_outlier_fill,
                           return_extras)

    Zmin_raw, t = create_dem(x, y, z, cellsize=cellsize, bin_type="min")
    thresholds = jnp.asarray(slope_threshold * (windows * cellsize),
                             dtype=jnp.float32)
    Zpro, object_cells, drop_raster, coeffs_Z, coeffs_S = _smrf_raster(
        Zmin_raw, tuple(int(w) for w in windows), thresholds,
        jnp.float32(low_filter_slope * cellsize), float(cellsize),
        bool(low_outlier_fill), bool(return_extras))

    # Host f64 inverse-affine for the point coordinates (precision),
    # then the fused device point stage.
    x64 = np.asarray(x, dtype=np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    c, r = (~t) * (x64, y64)
    z64 = np.asarray(z, dtype=np.float64)
    if r.size > int(chunk_points):
        is_object_point, elevation_values = _smrf_points_streamed(
            coeffs_Z, coeffs_S, r, c, z64, elevation_threshold,
            elevation_scaler, int(chunk_points),
            need_elev=bool(return_extras))
        if return_extras:  # the z plane is only read by the extras
            z_dev = jnp.asarray(z64, dtype=jnp.float32)
    else:
        z_dev = jnp.asarray(z64, dtype=jnp.float32)
        is_object_point, elevation_values = _smrf_points(
            coeffs_Z, coeffs_S, jnp.asarray(r, dtype=jnp.float32),
            jnp.asarray(c, dtype=jnp.float32), z_dev,
            jnp.float32(elevation_threshold),
            jnp.float32(elevation_scaler))

    if return_extras:
        rr = np.clip(np.round(r).astype(int), 0, Zpro.shape[0] - 1)
        cc = np.clip(np.round(c).astype(int), 0, Zpro.shape[1] - 1)
        when_dropped = np.asarray(drop_raster)[rr, cc]
        extras = {
            "above_ground_height": z_dev - elevation_values,
            "drop_raster": drop_raster,
            "when_dropped": when_dropped,
        }
        return Zpro, t, object_cells, is_object_point, extras
    return Zpro, t, object_cells, is_object_point


def _smrf_exact(x, y, z, cellsize, windows, slope_threshold,
                elevation_threshold, elevation_scaler, low_filter_slope,
                low_outlier_fill, return_extras):
    """Float64 SMRF on the CPU backend: the same fused jitted programs
    retraced in x64, fed by an f64 host scatter.  CG runs at tol=1e-12
    so the spring equilibria agree with the reference's lsqr solutions
    far below every decision margin."""
    from ..ops.pointgrid import bin_points

    x64 = np.asarray(x, dtype=np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    z64 = np.asarray(z, dtype=np.float64)
    flat, valid, (ny, nx), t = bin_points(x64, y64, cellsize=cellsize)
    Zmin = np.full(ny * nx, np.inf)
    np.minimum.at(Zmin, flat[valid], z64[valid])
    Zmin[np.isinf(Zmin)] = np.nan
    Zmin = Zmin.reshape(ny, nx)

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        thresholds = jnp.asarray(
            slope_threshold * (windows * np.float64(cellsize)),
            dtype=jnp.float64)
        Zpro, object_cells, drop_raster, coeffs_Z, coeffs_S = _smrf_raster(
            jnp.asarray(Zmin), tuple(int(w) for w in windows), thresholds,
            jnp.float64(low_filter_slope * cellsize), float(cellsize),
            bool(low_outlier_fill), bool(return_extras),
            inpaint_tol=1e-12, inpaint_maxiter=100_000)
        c, r = (~t) * (x64, y64)
        is_object_point, elevation_values = _smrf_points(
            coeffs_Z, coeffs_S, jnp.asarray(r), jnp.asarray(c),
            jnp.asarray(z64), jnp.float64(elevation_threshold),
            jnp.float64(elevation_scaler))
        # inside the x64 context: outside it jnp.asarray(z64) would
        # silently downcast to f32 and above_ground_height would lose
        # the exact-mode precision the caller asked for
        if return_extras:
            agh = jnp.asarray(z64) - elevation_values

    if return_extras:
        rr = np.clip(np.round(r).astype(int), 0, ny - 1)
        cc = np.clip(np.round(c).astype(int), 0, nx - 1)
        extras = {
            "above_ground_height": agh,
            "drop_raster": drop_raster,
            "when_dropped": np.asarray(drop_raster)[rr, cc],
        }
        return Zpro, t, object_cells, is_object_point, extras
    return Zpro, t, object_cells, is_object_point


def smrf_las(filename, out_filename, cellsize=1, windows=5,
             slope_threshold=.15, elevation_threshold=.5,
             elevation_scaler=1.25, low_filter_slope=5,
             low_outlier_fill=False, chunk_points=4_000_000,
             ground_class=2, object_class=1):
    """Streamed end-to-end SMRF over a whole LAS file: grid, filter,
    classify every point, and write the ASPRS classification codes
    back — in the fixed memory of one chunk, whatever the file size.

    The reference's workflow for this (examples/"SMRF Classification
    using laspy*.ipynb") materializes the full cloud three times:
    read_las -> smrf -> laspy re-write.  Here pass 1 streams the file
    through the native decoder into the device scatter
    (``create_dem_from_las``), the raster stage runs once on device,
    and pass 2 re-streams the points through the fused spline-lift
    classifier chunk by chunk.  The output file is a byte-exact copy
    of the input — every attribute, VLR and waveform block preserved —
    with ONLY the per-record classification field rewritten
    (``ground_class`` / ``object_class``; PDRF 0-5 keep their
    synthetic/keypoint/withheld flag bits, PDRF 6-10 their separate
    flag byte).

    Returns ``(Zpro, t, object_cells, stats)`` — the provisional DTM,
    its affine transform, the object-cell grid, and a dict with
    ``n_points`` / ``n_ground`` / ``n_object``.

    The grid frame comes from the LAS header's min/max block (see
    ``create_dem_from_las``); classification decisions match
    ``smrf(x, y, z, ...)`` run in-memory on the same frame
    (reference pipeline: neilpy.py:1685-1808).
    """
    import os
    import shutil

    from ..ops.pointgrid import create_dem_from_las
    from ..io.las_native import native_available

    if os.path.abspath(str(filename)) == os.path.abspath(str(out_filename)):
        raise ValueError("out_filename must differ from the input file")
    for name, v in (("ground_class", ground_class),
                    ("object_class", object_class)):
        if not 0 <= int(v) <= 255:
            raise ValueError(f"{name} must be a uint8 ASPRS code")

    if np.isscalar(windows):
        windows = np.arange(windows) + 1
    windows = np.atleast_1d(np.asarray(windows))

    # ---- pass 1: streamed min-surface gridding + raster stage ----
    Zmin_raw, t = create_dem_from_las(filename, cellsize=cellsize,
                                      bin_type="min",
                                      chunk_points=chunk_points)
    thresholds = jnp.asarray(slope_threshold * (windows * cellsize),
                             dtype=jnp.float32)
    Zpro, object_cells, _, coeffs_Z, coeffs_S = _smrf_raster(
        Zmin_raw, tuple(int(w) for w in windows), thresholds,
        jnp.float32(low_filter_slope * cellsize), float(cellsize),
        bool(low_outlier_fill), False)

    # ---- header facts for the classification byte-patch ----
    if native_available():
        from ..io.las_native import read_header, read_las_chunks
        hdr = read_header(filename)
        chunks = read_las_chunks(filename, chunk_points=chunk_points)
    else:
        from ..io.las import read_las_columns
        hdr, cols = read_las_columns(filename)
        chunks = iter([cols])
    pdrf = int(hdr["point_data_format_id"])
    if pdrf <= 5:
        # PDRF 0-5 keep only 5 bits of classification (LAS 1.1-1.3
        # table 8): a code > 31 would be silently rewritten as a
        # different class by the & 0x1F below — reject it instead
        for name, v in (("ground_class", ground_class),
                        ("object_class", object_class)):
            if int(v) > 31:
                raise ValueError(
                    f"{name}={int(v)} does not fit PDRF {pdrf}'s 5-bit "
                    "classification field (codes 0-31)")
    reclen = int(hdr["point_data_record_length"])
    off0 = int(hdr["point_data_offset"])
    n = int(hdr["num_point_records"])
    # classification byte: PDRF 0-5 share it with the 3 flag bits
    # (LAS 1.1-1.3 spec table 8); PDRF 6-10 give it a full byte
    cls_off = 15 if pdrf <= 5 else 16

    # ---- pass 2: copy, then re-stream points -> classify -> patch ----
    shutil.copyfile(filename, out_filename)
    mm = np.memmap(out_filename, dtype=np.uint8, mode="r+")
    # strided writable view over each record's classification byte
    cls_view = mm[off0 + cls_off: off0 + (n - 1) * reclen + cls_off + 1:
                  reclen]

    pad_to = min(int(chunk_points), max(n, 1))
    n_object = 0
    pos = 0
    for chunk in chunks:
        x64 = np.asarray(chunk["x"], dtype=np.float64)
        y64 = np.asarray(chunk["y"], dtype=np.float64)
        z64 = np.asarray(chunk["z"], dtype=np.float64)
        m = x64.size
        c, r = (~t) * (x64, y64)
        rr = np.asarray(r, dtype=np.float32)
        cc = np.asarray(c, dtype=np.float32)
        zz = np.asarray(z64, dtype=np.float32)
        if m < pad_to:  # fixed shape -> one device compile
            pad = pad_to - m
            rr = np.concatenate([rr, np.zeros(pad, np.float32)])
            cc = np.concatenate([cc, np.zeros(pad, np.float32)])
            zz = np.concatenate([zz, np.zeros(pad, np.float32)])
        is_obj, _ = _smrf_points(coeffs_Z, coeffs_S, jnp.asarray(rr),
                             jnp.asarray(cc), jnp.asarray(zz),
                             jnp.float32(elevation_threshold),
                             jnp.float32(elevation_scaler))
        is_obj = np.asarray(is_obj)[:m]
        cls = np.where(is_obj, np.uint8(object_class),
                       np.uint8(ground_class)).astype(np.uint8)
        if pdrf <= 5:
            cls_view[pos:pos + m] = ((cls_view[pos:pos + m] & 0xE0)
                                     | (cls & 0x1F))
        else:
            cls_view[pos:pos + m] = cls
        n_object += int(is_obj.sum())
        pos += m
    mm.flush()
    if pos != n:
        raise RuntimeError(
            f"classified {pos} of {n} header-declared points — "
            "truncated or inconsistent LAS file")
    stats = {"n_points": n, "n_object": n_object,
             "n_ground": n - n_object}
    return Zpro, t, object_cells, stats
