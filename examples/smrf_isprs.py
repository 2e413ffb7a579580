"""The Simple Morphological Filter (SMRF) — runnable port of the
reference notebook "smrf/The Simple Morphological Filter (SMRF) for
Point Cloud Processing.ipynb".

Two parts, same as the notebook:

1. the basic LAS use-case (cell 2): lidar -> DSM (max + inpaint) ->
   SMRF DTM -> bonemaps -> GeoTIFF + worldfile.  The notebook's
   ``DK22_partial.las`` is absent from the reference mount, so a small
   synthetic urban scene is written with our own LAS writer and read
   back with ``read_las`` — the same I/O path the notebook exercises.
2. the canonical ISPRS accuracy cell (cell 5): samp12 with the
   published "best overall parameters" (windows=18, slope .15,
   elev .5, scaler 1.25) and the notebook's exact error formulas.
   Stored notebook outputs: Type I 2.006%, Type II 4.125%,
   Total 3.091%, Cohen's kappa 93.81.

    python examples/smrf_isprs.py
"""

import os
import sys

import numpy as np

for _p in (os.path.dirname(os.path.abspath(__file__)),
           os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import neilpy_tpu as nt
from _common import FAST, out, use_agg

plt = use_agg()

# ----------------------------------------------------------------------
# Part 1 — basic use-case (notebook cell 2), on a synthetic scene
# ----------------------------------------------------------------------
rng = np.random.default_rng(11)
n_ground = 4_000 if FAST else 60_000
ext = 120.0                       # metres
gx = rng.uniform(0, ext, n_ground)
gy = rng.uniform(0, ext, n_ground)
gz = (2.0 * np.sin(gx / 18.0) + 1.5 * np.cos(gy / 23.0)
      + rng.normal(0, .03, n_ground))

# a few "buildings": dense elevated blocks on top of the ground surface
bx, by, bz = [], [], []
for (cx, cy, w, h) in [(30, 40, 14, 6.0), (80, 75, 18, 9.0),
                       (55, 20, 10, 4.0)]:
    m = n_ground // 12
    px = rng.uniform(cx - w / 2, cx + w / 2, m)
    py = rng.uniform(cy - w / 2, cy + w / 2, m)
    pz = (2.0 * np.sin(px / 18.0) + 1.5 * np.cos(py / 23.0)
          + h + rng.normal(0, .05, m))
    bx.append(px), by.append(py), bz.append(pz)
x = np.concatenate([gx] + bx)
y = np.concatenate([gy] + by)
z = np.concatenate([gz] + bz)
truth_object = np.concatenate(
    [np.zeros(n_ground, bool)] + [np.ones(len(v), bool) for v in bx])

# write + read back through the LAS layer, like the notebook's read_las
las_fn = out("scene.las")
nt.write_las(las_fn, x, y, z)
header, df = nt.read_las(las_fn)
assert len(df) == len(x)
assert np.allclose(df.x, x, atol=.001)      # LAS scale is 0.001
print(f"LAS round-trip: {len(df)} points, "
      f"version {header['version_major']}.{header['version_minor']}")

cellsize = 2.0
Zmax, Tmax = nt.create_dem(df.x, df.y, df.z, cellsize=cellsize,
                           bin_type="max", inpaint=True)
Zsmrf, Tsmrf, obj_cells, obj_points = nt.smrf(
    df.x, df.y, df.z, cellsize=cellsize, windows=3, slope_threshold=.15,
    elevation_threshold=.5, elevation_scaler=1.25)
assert np.isfinite(np.asarray(Zsmrf)).all()

# the DTM must have shaved the buildings down to ground level: compare
# against the analytic ground surface at each grid cell
rows = np.arange(Zsmrf.shape[0])
cols = np.arange(Zsmrf.shape[1])
cgrid, rgrid = np.meshgrid(cols, rows)
gxg, gyg = Tsmrf * (cgrid + .5, rgrid + .5)
true_ground = 2.0 * np.sin(gxg / 18.0) + 1.5 * np.cos(gyg / 23.0)
dtm_err = np.nanmax(np.abs(np.asarray(Zsmrf) - true_ground))
print(f"DTM vs analytic ground, max abs error: {dtm_err:.2f} m")
assert dtm_err < 1.5, dtm_err                # buildings were 4-9 m tall

# point classification should recover the seeded buildings
agree = np.mean(np.asarray(obj_points).astype(bool) == truth_object)
print(f"object-point agreement with seeded truth: {100 * agree:.1f}%")
assert agree > 0.97, agree

Bmax = nt.pssm(Zmax, cellsize=cellsize)
Bsmrf = nt.pssm(Zsmrf, cellsize=cellsize)
plt.imsave(out("scene_smrfed_bonemap.png"), np.asarray(Bsmrf))
nt.imwrite(out("scene_smrfed.tif"), np.asarray(Zsmrf, dtype=np.float32),
           {"transform": Tsmrf, "nodata": None})
nt.write_worldfile(Tsmrf, out("scene_smrfed_bonemap.pgw"))
print("wrote", out("scene_smrfed.tif"), "+ bonemap/pgw")

fig, axes = plt.subplots(1, 2, figsize=(10, 4))
axes[0].imshow(Bmax)
axes[0].set_title("DSM bonemap (max)")
axes[1].imshow(Bsmrf)
axes[1].set_title("SMRF DTM bonemap")
fig.savefig(out("smrf_bonemaps.png"), dpi=90)
plt.close(fig)

# ----------------------------------------------------------------------
# Part 2 — ISPRS samp12 accuracy (notebook cell 5, exact formulas)
# ----------------------------------------------------------------------
samp = "/root/reference/sample_data/samp12.txt"
if not os.path.exists(samp):
    print("ISPRS sample data unavailable; skipping the accuracy part")
    print("smrf isprs example complete")
    sys.exit(0)

import pandas as pd

df = pd.read_csv(samp, header=None, names=["x", "y", "z", "g"],
                 delimiter="\t")
cellsize = 1

# DSM for reference to the processed set (as in the notebook)
Zdsm, Tdsm = nt.create_dem(df.x, df.y, df.z, cellsize, bin_type="max",
                           inpaint=True)

# best overall parameters for all samples (Pingel et al. 2013)
windows = 18
slope_threshold = .15
elevation_threshold = .5
elevation_scaler = 1.25
Zs, Ts, obj_cells, obj_points = nt.smrf(
    df.x, df.y, df.z, cellsize, windows, slope_threshold,
    elevation_threshold, elevation_scaler)
obj_points = np.asarray(obj_points)

# the notebook's formulas, verbatim
total_error = 1 - np.sum(obj_points == df.g) / len(df)
type_I_error = np.sum((df.g == 0) & (obj_points == 1)) / np.sum(df.g == 1)
type_II_error = np.sum((df.g == 1) & (obj_points == 0)) / np.sum(df.g == 0)
# exact Cohen's kappa from the full confusion counts (nt.score samples
# with replacement, which would blur the comparison to 93.81)
po = np.mean(obj_points == df.g)
pe = (np.mean(df.g == 0) * np.mean(obj_points == 0)
      + np.mean(df.g == 1) * np.mean(obj_points == 1))
kappa = (po - pe) / (1 - pe)

print("Type I Error:  ", 100 * type_I_error)
print("Type II Error: ", 100 * type_II_error)
print("Total Error:   ", 100 * total_error)
print("Cohen's Kappa: ", 100 * kappa)

# stored notebook outputs: 2.006 / 4.125 / 3.091 / 93.81 (f64 CPU);
# the f32 device pipeline lands within a few thousandths
assert abs(100 * total_error - 3.091) < 0.05, total_error
assert abs(100 * type_I_error - 2.006) < 0.15, type_I_error
assert abs(100 * type_II_error - 4.125) < 0.25, type_II_error
assert abs(100 * kappa - 93.81) < 0.3, kappa

print("smrf isprs example complete")
