"""Production out-of-core pipeline: disk -> terrain products -> disk,
and whole-file lidar classification, in fixed memory.

The reference's biggest-raster story is `apply_parallel` over an
in-RAM array (test_neilpy.py:35-47) and its lidar story materializes
the whole cloud (read_las -> smrf -> laspy rewrite, the "SMRF
Classification using laspy" notebook).  This example shows the
Device-side equivalents for inputs that do NOT fit in memory:

1. a (Big)TIFF DEM streamed straight FROM DISK through the fused
   mosaic kernel via `GeoTiffSource` windowed reads (only the
   strips/tiles each tile window touches are decoded), with
   tile-granular checkpoint/resume, products written back as
   georeferenced GeoTIFFs;
2. a LAS file streamed through SMRF with `smrf_las`: the output file
   is a byte-exact copy with ONLY the classification field rewritten.

    python examples/out_of_core_pipeline.py
"""

import os
import sys

import numpy as np

for _p in (os.path.dirname(os.path.abspath(__file__)),
           os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import neilpy_tpu as nt
from _common import FAST, out

# ---------------------------------------------------------------- #
# 1. DEM on disk -> streamed terrain products -> GeoTIFFs on disk   #
# ---------------------------------------------------------------- #
H, W = (96, 128) if FAST else (2048, 3072)
rng = np.random.default_rng(11)
Z = (rng.normal(size=(H, W)).cumsum(axis=0) / 3).astype(np.float32)
T = nt.from_origin(500000, 4200000, 10, 10)
dem_fn = out("big_dem.tif")
# deflate-compressed on disk; windowed reads decode per-strip
nt.write_geotiff(dem_fn, Z, transform=T, crs=32618, compress="deflate")

src = nt.GeoTiffSource(dem_fn)          # lazy: nothing decoded yet
lookup, windows, gi_r = (3, np.array([1]), 1) if FAST else \
                        (25, np.arange(1, 8), 3)
ck = out("mosaic_ckpt.json")
G, O, MI = nt.mosaic_terrain_products(
    src, cellsize=10, lookup_pixels=lookup, windows=windows,
    gi_radius=gi_r, tile_size=48 if FAST else 1024, checkpoint=ck)

# products carry the source georeferencing back out
meta = dict(src.meta, dtype=str(G.dtype))
nt.imwrite(out("geomorphons.tif"), G, metadata=meta)
nt.imwrite(out("objects.tif"), O.astype(np.uint8),
           metadata=dict(meta, dtype="uint8"))
nt.imwrite(out("morans_i.tif"), MI, metadata=dict(meta, dtype="float32"))

# oracle: streaming from disk == computing from the in-RAM array
G2, O2, MI2 = nt.mosaic_terrain_products(
    Z, cellsize=10, lookup_pixels=lookup, windows=windows,
    gi_radius=gi_r, tile_size=48 if FAST else 1024)
assert (G == G2).all() and (O == O2).all()
assert np.allclose(MI, MI2, equal_nan=True)

# windowed re-read of a product: transform shifts to the window origin
win = ((H // 4, H // 2), (W // 4, W // 2))
Gw, mw = nt.imread(out("geomorphons.tif"), window=win)
assert (Gw == G[win[0][0]:win[0][1], win[1][0]:win[1][1]]).all()
assert mw["transform"] * (0, 0) == meta["transform"] * (win[1][0],
                                                        win[0][0])
print(f"from-disk mosaic == in-RAM mosaic on {H}x{W}; "
      f"windowed product read OK")

# ---------------------------------------------------------------- #
# 2. LAS on disk -> streamed SMRF classification -> LAS on disk     #
# ---------------------------------------------------------------- #
n = 4000 if FAST else 400_000
x = np.round(rng.uniform(0, 120, n), 3)
y = np.round(rng.uniform(0, 90, n), 3)
ground = 4 * np.sin(x / 20) + 3 * np.cos(y / 15)
is_obj_truth = rng.random(n) < 0.12
z = np.round(ground + is_obj_truth * rng.uniform(3, 9, n), 3)
las_in, las_out = out("cloud.las"), out("cloud_classified.las")
nt.write_las(las_in, x, y, z)

Zpro, t, cells, stats = nt.smrf_las(
    las_in, las_out, cellsize=1, windows=np.array([1, 2]),
    chunk_points=n // 3 + 1)            # force multi-chunk streaming
assert stats["n_points"] == n
_, df = nt.read_las(las_out)
pred_obj = np.asarray(df["class"]) == 1
# SMRF should separate the planted objects well on this easy terrain
agree = np.mean(pred_obj == is_obj_truth)
assert agree > 0.9, agree
print(f"smrf_las classified {stats['n_points']} pts "
      f"({stats['n_ground']} ground / {stats['n_object']} object), "
      f"truth agreement {agree:.3f}")
print("out-of-core pipeline complete")
