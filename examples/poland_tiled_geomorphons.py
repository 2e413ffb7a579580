"""Geomorphon Test — Poland: runnable port of the reference notebook
"Geomorphon Test - Poland.ipynb".

The notebook's point is SCALE: the 30 m EU-DEM of Poland (~1e8 px,
not shipped) is too big to classify in one call on the author's CPU,
so it runs ``apply_parallel(geomorphons_wrapper, Z, 1000,
lookup_pixels)`` — moving-window tiles with a lookup-radius halo —
then writes a paletted PNG + worldfile.  (Reference wall-clock: 42 min
whole-array, 26 min tiled; the fused ladder kernel on the GPU is not
measured at this size yet.)

This port runs the identical tiled call on a synthetic mountain DEM,
asserts the tiled result equals the untiled one inside the documented
halo contract, and writes the same outputs.  On the GPU, prefer
``mosaic_terrain_products`` / ``sharded_geomorphons`` for real mosaics
— ``apply_parallel`` is the notebook-compatible surface.

    python examples/poland_tiled_geomorphons.py
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

# a synthetic "country-sized" DEM stand-in (shrunk in CI mode)
H, W = (320, 480) if FAST else (1200, 1600)
rng = np.random.default_rng(30)
Z = rng.normal(size=(H, W)).astype(np.float32)
Z = np.cumsum(Z, axis=0) + np.cumsum(Z, axis=1)
Z *= 8.0                                     # mountainous relief
T = nt.from_origin(0.0, H * 30.0, 30.0, 30.0)
cellsize = 30.0
lookup_pixels = 8 if FAST else 15
threshold_angle = 1

# hypsometric tint (notebook cell 2)
fig = plt.figure(figsize=(6, 4))
plt.imshow(Z[::4, ::4], cmap="terrain")
fig.savefig(out("poland_tint.png"), dpi=90)
plt.close(fig)

# ----------------------------------------------------------------------
# The tiled moving-window classification (notebook cell 3), verbatim
# structure: a wrapper closed over the parameters, 1000-px tiles,
# lookup_pixels of overlap
# ----------------------------------------------------------------------
def gm_wrap(I):
    return nt.geomorphons(I, cellsize, lookup_pixels, threshold_angle)

tile = 128 if FAST else 1000
G = np.asarray(nt.apply_parallel(gm_wrap, Z.copy(), tile, lookup_pixels))
assert G.shape == Z.shape and G.dtype == np.uint8

# tiled == untiled inside the halo contract (pixels farther than the
# overlap from the global edge) — the property the notebook trusts
# skimage's apply_parallel to provide
G_full = np.asarray(gm_wrap(Z))
b = lookup_pixels
agree = np.mean(G[b:-b, b:-b] == G_full[b:-b, b:-b])
print(f"tiled vs untiled interior agreement: {agree:.6f}")
assert agree == 1.0, agree

# class histogram sanity: slopes/ridges/valleys dominate mountain DEMs
counts = np.bincount(G.ravel(), minlength=11)
print("class histogram:", counts[1:])
assert counts[6] > 0.05 * G.size            # slope is well represented

# ----------------------------------------------------------------------
# Paletted PNG + worldfile (notebook cells 4-5)
# ----------------------------------------------------------------------
nt.write_paletted_png(out("poland_geomorphon.png"), G,
                      nt.geomorphon_cmap())
nt.write_worldfile(T, out("poland_geomorphon.pgw"))
print("wrote", out("poland_geomorphon.png"), "+ .pgw")

print("poland tiled geomorphons complete")
