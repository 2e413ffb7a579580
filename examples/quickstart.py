"""Quickstart: the three headline workflows, end to end.

Mirrors the reference's example notebooks (SMRF classification,
geomorphon/terrain visualization, big-raster tiling) as one runnable
script.  Works on CPU or GPU; point ISPRS_DIR somewhere containing the
ISPRS ``samp*.txt`` clouds (tab-separated x y z label) or let the
synthetic fallback run.

    python examples/quickstart.py
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import neilpy_tpu as nt
from neilpy_tpu.backend import enable_compile_cache

enable_compile_cache()

ISPRS_DIR = os.environ.get("ISPRS_DIR", "/root/reference/sample_data")
OUT = os.environ.get("OUT_DIR", os.path.join(tempfile.gettempdir(),
                                             "neilpy_tpu_quickstart"))
os.makedirs(OUT, exist_ok=True)


# ----------------------------------------------------------------------
# 1. Lidar -> DTM -> ground classification (SMRF)
# ----------------------------------------------------------------------
samp = os.path.join(ISPRS_DIR, "samp12.txt")
if os.path.exists(samp):
    import pandas as pd
    df = pd.read_csv(samp, header=None, names=["x", "y", "z", "g"],
                     delimiter="\t")
    x, y, z, labels = df.x, df.y, df.z, df.g.values
else:  # synthetic bowl with boxes on top
    rng = np.random.default_rng(0)
    n = 30000
    x = rng.uniform(0, 200, n)
    y = rng.uniform(0, 200, n)
    z = 0.002 * ((x - 100) ** 2 + (y - 100) ** 2) + rng.normal(0, .05, n)
    obj = rng.random(n) < 0.15
    z = z + obj * rng.uniform(2, 8, n)
    labels = obj.astype(int)

with nt.Throughput("smrf", items=len(x), unit="pts") as tp:
    dtm, T, obj_grid, obj_pts = nt.smrf(
        x, y, z, cellsize=1, windows=18, slope_threshold=.15,
        elevation_threshold=.5, elevation_scaler=1.25)
    tp.result = obj_pts
err = 1 - np.mean(np.asarray(obj_pts) == labels)
print(f"SMRF total error vs labels: {100 * err:.3f}%")
nt.imwrite(os.path.join(OUT, "dtm.tif"), np.asarray(dtm),
           {"transform": T, "nodata": None})
print("wrote", os.path.join(OUT, "dtm.tif"))

# ----------------------------------------------------------------------
# 2. DEM -> geomorphons + Swiss relief shading
# ----------------------------------------------------------------------
Z = np.asarray(dtm)
with nt.Throughput("geomorphons", items=Z.size) as tp:
    tp.result = G = nt.geomorphons(Z, cellsize=1, lookup_pixels=20,
                                   threshold_angle=1)
print("class histogram:", np.bincount(np.asarray(G).ravel(),
                                      minlength=11)[1:])
rgb = np.asarray(nt.swiss_shading(Z, cellsize=1))
nt.write_paletted_png(os.path.join(OUT, "geomorphons.png"),
                      np.asarray(G), nt.geomorphon_cmap())
print("wrote", os.path.join(OUT, "geomorphons.png"))

# ----------------------------------------------------------------------
# 3. Bigger-than-memory mosaics: fused multi-product streaming
# ----------------------------------------------------------------------
big = np.tile(Z, (2, 2))
ck = os.path.join(OUT, "tiles.json")
if os.path.exists(ck):
    os.remove(ck)  # fresh demo run (keep it to showcase resume)
Gm, obj, moran = nt.mosaic_terrain_products(
    big, cellsize=1, lookup_pixels=10, windows=5, gi_radius=3,
    tile_size=256,
    checkpoint=os.path.join(OUT, "tiles.json"))
print(f"mosaic products on {big.shape}: geomorphons {Gm.dtype}, "
      f"objects {obj.mean():.1%}, Moran's I mean {np.nanmean(moran):.3f}")
