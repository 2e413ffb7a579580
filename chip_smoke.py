"""Smoke test of the terrain/lidar main path on the GPU.

Runs in ONE process that opens the card once and drives every phase
through the public entry points at the sizes users run, comparing each
with the repository's references (the XLA engine on the card, and the
float64 numpy/scipy oracles in ``tests/reference_impls.py``).  Any
failed comparison raises, so the script exits non-zero and prints no
result line.  Times printed are smoke timings (first call including
compilation, then one warm call), not benchmark numbers.

    python chip_smoke.py [--seed N]     # one card, every phase
    python chip_smoke.py --four         # the 4-card mesh paths only

The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero before any phase runs.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# ---- tolerances (each with its precision and reason) -----------------
#: f64 decision margin (degrees) below which a geomorphon class may flip
#: between f32 engines: the kernel compares tangents exactly, the XLA
#: engine compares rounded f32 angles, so only ties can differ
TIE_MARGIN_DEG = 1e-4
#: at most this many tie flips are checked one by one against the f64
#: reference; more than that is a real disagreement, not ties
MAX_TIES = 2000
#: openness (degrees): the kernel takes atan in-kernel (libdevice), the
#: XLA engine in its own epilogue; both f32, a few ulp of pi/2 apart
#: before the mean over 8 directions
OPENNESS_TOL_DEG = 1e-4
#: skyview factor: t/sqrt(1+t^2) summed over 8 directions in f32; the
#: two engines differ only in sqrt/divide rounding and summation order
SVF_TOL = 2e-6
#: SMRF total error (fraction of points) on the synthetic tile with
#: seeded labels, f32 on the card
SMRF_ERROR_BOUND = 0.02
#: f32 rounding of a decision at terrain heights ~1e2 m, allowing for
#: the f32 CG inpaint's residual (metres): the f64 SMRF oracle's
#: ladder and point-test margins below which an f32 label may differ
SMRF_TIE_M = 2e-3
#: Moran's I tiled vs untiled: f32 sliding sums reassociate between the
#: tile and whole-raster schedules (values O(10-100))
MORAN_RTOL, MORAN_ATOL = 1e-4, 1e-3
#: Gi* z-scores and local Moran's I vs f64 sums: f32 neighbourhood sums
#: of ~81 values of magnitude ~1e2 and f32 global moments over ~6.7e7
#: cells, each with relative error ~1e-6
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3


def card_info():
    """``name, power.limit`` from nvidia-smi, in a child process that
    never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out or "nvidia-smi gave no output"


def report(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _memory_analysis(fn, *args):
    """Argument / output / temp bytes of ``fn`` compiled under jit."""
    import jax
    m = jax.jit(fn).lower(*args).compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def timed(fn):
    """(result, first-call seconds incl. compile, warm seconds)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, setup, time.perf_counter() - t0


def terrain(seed, shape):
    """Seeded random-walk terrain (f32, host)."""
    rng = np.random.default_rng(seed)
    Z = np.cumsum(rng.standard_normal(shape, dtype=np.float32), axis=0,
                  dtype=np.float32)
    Z += np.cumsum(rng.standard_normal(shape, dtype=np.float32), axis=1,
                   dtype=np.float32)
    return Z


# ---- geomorphons ---------------------------------------------------
def _tie_margins(Z, pix, cellsize, lookup, fast):
    """f64 reference margin at each pixel, from a window clipped to the
    raster with the full ladder reach around the pixel (so the window
    edge is the raster edge wherever a ray can reach it)."""
    from tests.reference_impls import np_geomorphons
    H, W = Z.shape
    out = []
    for r, c in pix:
        r0, r1 = max(0, r - lookup), min(H, r + lookup + 1)
        c0, c1 = max(0, c - lookup), min(W, c + lookup + 1)
        _, m = np_geomorphons(Z[r0:r1, c0:c1].astype(np.float64),
                              cellsize, lookup, 1, fast=fast,
                              return_margin=True)
        out.append(float(m[r - r0, c - c0]))
    return np.asarray(out)


def phase_geomorphons(seed, shape=(10_000, 10_000), lookup=50,
                      cellsize=10.0, win=512, n_win=3):
    """``geomorphons(engine="auto")``, exact and fast ladders, against
    (a) the XLA engine on the whole raster and (b) the f64 reference on
    ``n_win`` seeded windows with their ladder halo."""
    import jax.numpy as jnp
    import neilpy_tpu as nt
    from tests.reference_impls import np_geomorphons
    Z = terrain(seed, shape)
    Zd = jnp.asarray(Z)
    rng = np.random.default_rng(seed + 1)
    H, W = shape
    origins = [(int(rng.integers(lookup, H - win - lookup + 1)),
                int(rng.integers(lookup, W - win - lookup + 1)))
               for _ in range(n_win)]
    kw = dict(cellsize=cellsize, lookup_pixels=lookup, threshold_angle=1)
    for fast in (False, True):
        G, setup, warm = timed(lambda: nt.geomorphons(Zd, fast=fast, **kw))
        Gx = nt.geomorphons(Zd, fast=fast, engine="xla", **kw)
        diff = np.argwhere(np.asarray(G != Gx))
        check(len(diff) <= MAX_TIES,
              f"geomorphons fast={fast}: {len(diff)} pixels differ from "
              "the XLA engine")
        m = _tie_margins(Z, diff, cellsize, lookup, fast)
        check((m < TIE_MARGIN_DEG).all(),
              f"geomorphons fast={fast}: a pixel differing from the XLA "
              f"engine has f64 margin {m.max() if m.size else 0} deg")
        G = np.asarray(G)
        win_diffs = 0
        for r, c in origins:
            ref, margin = np_geomorphons(
                Z[r - lookup:r + win + lookup,
                  c - lookup:c + win + lookup].astype(np.float64),
                cellsize, lookup, 1, fast=fast, return_margin=True)
            core = np.s_[lookup:lookup + win, lookup:lookup + win]
            bad = G[r:r + win, c:c + win] != ref[core]
            check((margin[core][bad] < TIE_MARGIN_DEG).all(),
                  f"geomorphons fast={fast}: window {(r, c)} differs from "
                  "the f64 reference beyond decision ties")
            win_diffs += int(bad.sum())
        mem = None if fast else _memory_analysis(
            lambda z: nt.geomorphons(z, **kw), Zd)
        report("geomorphons", fast=fast, shape=list(shape), lookup=lookup,
               vs_xla_tie_pixels=len(diff), vs_f64_tie_pixels=win_diffs,
               f64_windows=n_win, setup_s=setup, warm_s=warm,
               memory_analysis=mem, peak_bytes=_peak_bytes())
    return Z


def phase_openness(Z, lookup=50, cellsize=10.0):
    """``openness_pair`` and ``skyview_factor`` against the XLA engine."""
    import jax.numpy as jnp
    import neilpy_tpu as nt
    Zd = jnp.asarray(Z)

    def maxdiff(a, b):
        fa, fb = jnp.isfinite(a), jnp.isfinite(b)
        check(bool(jnp.all(fa == fb)), "non-finite pixels differ")
        return float(jnp.max(jnp.where(fa, jnp.abs(a - b), 0.0)))

    (pos, neg), setup, warm = timed(lambda: nt.openness_pair(
        Zd, cellsize=cellsize, lookup_pixels=lookup))
    px, nx_ = nt.openness_pair(Zd, cellsize=cellsize, lookup_pixels=lookup,
                               engine="xla")
    d_open = max(maxdiff(pos, px), maxdiff(neg, nx_))
    check(d_open <= OPENNESS_TOL_DEG, f"openness differs by {d_open} deg")
    report("openness", max_abs_diff_deg=d_open, tol=OPENNESS_TOL_DEG,
           setup_s=setup, warm_s=warm)
    s, setup, warm = timed(lambda: nt.skyview_factor(
        Zd, cellsize=cellsize, lookup_pixels=lookup))
    d_svf = maxdiff(s, nt.skyview_factor(Zd, cellsize=cellsize,
                                         lookup_pixels=lookup,
                                         engine="xla"))
    check(d_svf <= SVF_TOL, f"skyview differs by {d_svf}")
    report("skyview", max_abs_diff=d_svf, tol=SVF_TOL, setup_s=setup,
           warm_s=warm, peak_bytes=_peak_bytes())


# ---- SMRF --------------------------------------------------------------
def synthetic_tile(seed, extent=1000.0, density=8.0):
    """Seeded lidar tile: smooth ground, flat-roofed buildings and tree
    crowns, with ASPRS labels (2 ground, 1 other).  Returns
    (x, y, z, label) in a UTM-like frame."""
    rng = np.random.default_rng(seed)
    n = int(extent * extent * density)
    x = rng.uniform(0, extent, n)
    y = rng.uniform(0, extent, n)
    z = (100 + 8 * np.sin(x / 97) * np.cos(y / 131) + 0.01 * x
         + rng.normal(0, 0.03, n))
    res = 0.25  # footprint raster (m): edges fall inside 1 m cells
    cells = int(np.ceil(extent / res))
    bld = np.zeros((cells, cells))
    for _ in range(int(extent * extent / 5000)):
        cx, cy = rng.uniform(0, extent, 2) / res
        hw, hh = rng.uniform(4, 15, 2) / res
        bld[int(max(cy - hh, 0)):int(cy + hh),
            int(max(cx - hw, 0)):int(cx + hw)] = rng.uniform(4, 15)
    crown = np.zeros((cells, cells))
    k = int(6 / res)
    yy, xx = np.mgrid[-k:k + 1, -k:k + 1] * res
    for _ in range(int(extent * extent / 400)):
        cx, cy = rng.integers(k, cells - k, 2)
        rad, h = rng.uniform(2, 6), rng.uniform(5, 20)
        sl = np.s_[cy - k:cy + k + 1, cx - k:cx + k + 1]
        crown[sl] = np.maximum(crown[sl], (xx ** 2 + yy ** 2 <= rad ** 2) * h)
    ci = (np.minimum((y / res).astype(int), cells - 1),
          np.minimum((x / res).astype(int), cells - 1))
    hb, hc = bld[ci], crown[ci]
    label = np.full(n, 2, np.uint8)
    on_roof = hb > 0
    z[on_roof] += hb[on_roof]
    hit = ~on_roof & (hc > 0) & (rng.random(n) < 0.6)
    z[hit] += hc[hit] * rng.uniform(0.5, 1.0, hit.sum())
    label[on_roof | hit] = 1
    return x + 500000.0, y + 4200000.0, z, label


def phase_smrf(seed, extent=1000.0, density=8.0, crop=200.0):
    """``smrf_las`` file to file on a synthetic tile (total error vs the
    seeded labels), and ``smrf`` on a crop vs the f64 oracle."""
    import neilpy_tpu as nt
    from neilpy_tpu.io.las import read_las_columns
    from neilpy_tpu.io.las_native import native_available
    from tests.reference_impls import np_smrf
    x, y, z, label = synthetic_tile(seed, extent, density)
    params = dict(cellsize=1, windows=18, slope_threshold=.15,
                  elevation_threshold=.5, elevation_scaler=1.25)
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "tile.las"), os.path.join(d, "out.las")
        nt.write_las(src, x, y, z, classification=label)
        _, setup, warm = timed(lambda: nt.smrf_las(src, dst, **params)[0])
        cls = read_las_columns(dst)[1]["class"] & 0x1F
    err = float(np.mean((cls == 2) != (label == 2)))
    check(err <= SMRF_ERROR_BOUND, f"smrf_las total error {err:.4f}")
    report("smrf_las", points=int(x.size), total_error=err,
           bound=SMRF_ERROR_BOUND, native_decoder=native_available(),
           setup_s=setup, warm_s=warm, peak_bytes=_peak_bytes())

    x0, y0 = x.min() + (extent - crop) / 2, y.min() + (extent - crop) / 2
    sel = (x >= x0) & (x < x0 + crop) & (y >= y0) & (y < y0 + crop)
    xs, ys, zs = x[sel], y[sel], z[sel]
    _, t, _, obj = nt.smrf(xs, ys, zs, **params)
    obj = np.asarray(obj)
    ref, _, cell_margin, pt_margin = np_smrf(
        xs, ys, zs, 1, 18, .15, .5, 1.25, return_margin=True,
        return_point_margin=True)
    c, r = (~t) * (xs, ys)
    r = np.clip(r.astype(int), 0, cell_margin.shape[0] - 1)
    c = np.clip(c.astype(int), 0, cell_margin.shape[1] - 1)
    tie = (cell_margin[r, c] < SMRF_TIE_M) | (pt_margin < SMRF_TIE_M)
    bad = obj != ref
    check(not (bad & ~tie).any(),
          f"smrf crop: {int((bad & ~tie).sum())} labels differ from the "
          "f64 oracle outside decision ties")
    report("smrf_crop_vs_f64", points=int(xs.size), tie_points=int(bad.sum()),
           tie_margin_m=SMRF_TIE_M)
    return x, y, z


# ---- mosaic ----------------------------------------------------------
def _memmap_terrain(seed, side, d):
    Z = terrain(seed, (side, side))
    mm = np.memmap(os.path.join(d, "mosaic.f32"), dtype=np.float32,
                   mode="w+", shape=Z.shape)
    mm[:] = Z
    mm.flush()
    return mm


def _mosaic_kw(lookup, tile):
    return dict(cellsize=1, lookup_pixels=lookup, windows=5, gi_radius=3,
                tile_size=tile, products=("geomorphons", "objects",
                                          "moran"))


def phase_mosaic(seed, side=16384, tile=4096, lookup=50):
    """``mosaic_terrain_products`` from a memmap vs the untiled
    products on the card, compared away from the global boundary band
    where tile padding stands in for each kernel's edge rule."""
    import jax.numpy as jnp
    import neilpy_tpu as nt
    from neilpy_tpu.pipelines.mosaic import required_overlap
    kw = _mosaic_kw(lookup, tile)
    with tempfile.TemporaryDirectory() as d:
        Z = _memmap_terrain(seed, side, d)
        t0 = time.perf_counter()
        nt.mosaic_terrain_products(np.asarray(Z[:tile, :tile]), **kw)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        G, O, M = nt.mosaic_terrain_products(Z, **kw)
        warm = time.perf_counter() - t0
        Zh = np.asarray(Z)
        Zd = jnp.asarray(Zh)
    mean = float(Zh.mean(dtype=np.float64))
    s2 = float(np.mean((Zh.astype(np.float64) - mean) ** 2))
    Gu = np.asarray(nt.geomorphons(Zd, cellsize=1, lookup_pixels=lookup,
                                   threshold_angle=1))
    Ou = np.asarray(nt.progressive_filter(Zd, np.arange(5) + 1, 1, .15))
    Mu = np.asarray(nt.local_morans_i(Zd, footprint=3, mean=mean, s2=s2))
    ov = required_overlap(lookup, np.arange(5) + 1, 3, kw["products"])
    s = np.s_[ov:-ov, ov:-ov]
    check(np.array_equal(G[s], Gu[s]), "mosaic classes differ from untiled")
    check(np.array_equal(O[s], Ou[s]), "mosaic objects differ from untiled")
    np.testing.assert_allclose(M[s], Mu[s], rtol=MORAN_RTOL,
                               atol=MORAN_ATOL)
    report("mosaic", side=side, tile=tile, classes_equal=True,
           objects_equal=True, moran_max_abs_diff=float(
               np.max(np.abs(M[s] - Mu[s]))), setup_s=setup, wall_s=warm,
           peak_bytes=_peak_bytes())


# ---- statistics ------------------------------------------------------
def phase_stats(seed, side=8192, radius=5, win=256, n_win=3):
    """``rasterGi`` (Gi*, disk r) and ``local_morans_i`` vs f64 sums."""
    import jax.numpy as jnp
    import scipy.ndimage as ndi
    import neilpy_tpu as nt
    Z = terrain(seed, (side, side))
    Zd = jnp.asarray(Z)
    fp = np.asarray(nt.disk(radius))
    (gi, _, _), setup, warm = timed(lambda: nt.rasterGi(Zd, footprint=fp))
    lm = nt.local_morans_i(Zd, footprint=radius)
    gi, lm = np.asarray(gi), np.asarray(lm)
    Z64 = Z.astype(np.float64)
    n, mean = Z64.size, Z64.mean()
    var = np.mean((Z64 - mean) ** 2)
    sq = np.ones((2 * radius + 1,) * 2)
    sq[radius, radius] = 0
    rng = np.random.default_rng(seed + 2)
    worst = 0.0
    for _ in range(n_win):
        r, c = (int(v) for v in rng.integers(radius, side - win - radius, 2))
        blk = Z64[r - radius:r + win + radius, c - radius:c + win + radius]
        core = np.s_[radius:radius + win, radius:radius + win]
        w = fp.sum()
        s = ndi.correlate(blk, fp.astype(np.float64))[core]
        gi_ref = (s - w * mean) / np.sqrt((w / (n - 1)) * (n - w) * var)
        lag = ndi.correlate(blk - mean, sq)[core]
        lm_ref = (Z64[r:r + win, c:c + win] - mean) / var * lag
        for got, want in ((gi[r:r + win, c:c + win], gi_ref),
                          (lm[r:r + win, c:c + win], lm_ref)):
            np.testing.assert_allclose(got, want, rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
            worst = max(worst, float(np.max(np.abs(got - want))))
    report("statistics", side=side, radius=radius, windows=n_win,
           max_abs_diff=worst, setup_s=setup, warm_s=warm,
           peak_bytes=_peak_bytes())


# ---- gridding ----------------------------------------------------------
def phase_gridding(seed, n=20_000_000, extent=1000.0):
    """``create_dem`` (host f64 binning + device scatter-min) vs
    ``np.minimum.at`` on the same bins: exact."""
    import neilpy_tpu as nt
    from neilpy_tpu.ops.pointgrid import bin_points
    rng = np.random.default_rng(seed)
    x = rng.uniform(500000, 500000 + extent, n)
    y = rng.uniform(4200000, 4200000 + extent, n)
    z = rng.normal(300, 30, n)
    (I, _), setup, warm = timed(lambda: nt.create_dem(x, y, z, cellsize=1,
                                                      bin_type="min"))
    flat, valid, (ny, nx), _ = bin_points(x, y, cellsize=1)
    ref = np.full(ny * nx, np.inf, np.float32)
    np.minimum.at(ref, flat[valid], z.astype(np.float32)[valid])
    ref[np.isinf(ref)] = np.nan
    check(np.array_equal(np.asarray(I), ref.reshape(ny, nx),
                         equal_nan=True), "create_dem differs from host")
    report("gridding", points=n, grid=[ny, nx], exact=True, setup_s=setup,
           warm_s=warm, peak_bytes=_peak_bytes())


# ---- four cards --------------------------------------------------------
def phase_four(seed, n_dev=4, shape=(10_000, 10_000), lookup=50,
               extent=1000.0, density=8.0, mosaic_side=16384,
               mosaic_tile=4096):
    """The mesh paths on ``n_dev`` devices vs one device: sharded
    geomorphons (bit-equal), sharded SMRF (object masks), and the
    mesh-composed mosaic (bit-equal)."""
    import jax
    import jax.numpy as jnp
    import neilpy_tpu as nt
    from neilpy_tpu.dist import make_mesh, sharded_geomorphons
    from neilpy_tpu.dist.smrf import sharded_smrf
    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices, have {len(devs)}")
    mesh = make_mesh(devs)
    Z = terrain(seed, shape)
    kw = dict(cellsize=10.0, lookup_pixels=lookup, threshold_angle=1)
    Gs, setup, warm = timed(lambda: sharded_geomorphons(Z, mesh, **kw))
    check(len(Gs.sharding.device_set) == n_dev,
          "sharded geomorphons did not spread over the mesh")
    G1 = nt.geomorphons(jax.device_put(Z, devs[0]), **kw)
    check(np.array_equal(np.asarray(Gs), np.asarray(G1)),
          "sharded geomorphons differ from one device")
    report("four_geomorphons", mesh=dict(mesh.shape), equal=True,
           setup_s=setup, warm_s=warm)

    x, y, z, _ = synthetic_tile(seed, extent, density)
    params = (1, 18, .15, .5, 1.25)
    (zpro_s, _, oc_s, pts_s), setup, warm = timed(
        lambda: sharded_smrf(x, y, z, *params, mesh=mesh))
    check(all(len(a.sharding.device_set) == n_dev
              for a in (zpro_s, oc_s, pts_s)),
          "sharded smrf did not spread over the mesh")
    _, _, oc_1, pts_1 = nt.smrf(x, y, z, *params)
    cells = float(np.mean(np.asarray(oc_s) != np.asarray(oc_1)))
    pts = float(np.mean(np.asarray(pts_s) != np.asarray(pts_1)))
    check(cells == 0.0 and pts == 0.0,
          f"sharded smrf differs: {cells} of cells, {pts} of points")
    report("four_smrf", points=int(x.size), cells_differ=cells,
           points_differ=pts, setup_s=setup, warm_s=warm)

    mkw = _mosaic_kw(lookup, mosaic_tile)
    with tempfile.TemporaryDirectory() as d:
        Zm = _memmap_terrain(seed + 1, mosaic_side, d)
        t0 = time.perf_counter()
        out_m = nt.mosaic_terrain_products(Zm, mesh=mesh, **mkw)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_1 = nt.mosaic_terrain_products(Zm, **mkw)
        t_one = time.perf_counter() - t0
    for a, b in zip(out_m, out_1):
        check(np.array_equal(a, b, equal_nan=True),
              "mesh mosaic differs from the single-device mosaic")
    report("four_mosaic", side=mosaic_side, tile=mosaic_tile, equal=True,
           mesh_wall_s=t_mesh, one_device_wall_s=t_one)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh paths")
    args = ap.parse_args(argv)
    print(f"card: {card_info()}", flush=True)

    from neilpy_tpu.backend import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        return 1
    report("device", platform=dev.platform, kind=dev.device_kind,
           count=len(jax.devices()),
           note="smoke timings, not benchmark numbers")
    if args.four:
        phase_four(args.seed)
        count = 4
    else:
        Z = phase_geomorphons(args.seed)
        phase_openness(Z)
        del Z
        phase_smrf(args.seed)
        phase_mosaic(args.seed)
        phase_stats(args.seed)
        phase_gridding(args.seed)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
