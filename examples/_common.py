"""Shared plumbing for the runnable example ports.

The reference notebooks all open ``sample_data/sample_dem.tif`` (a ~10 m
Mercator NED extract around Mt. Washington, NH).  That file is absent
from the reference mount (only its sidecars survive), so the examples
load it when a copy is available (``SAMPLE_DEM`` env var or the
reference path) and otherwise synthesize a DEM with the golden raster's
dimensions and the aux.xml value range — the same stand-in the test
suite uses (tests/test_visibility.py).

Set ``EXAMPLE_FAST=1`` to shrink the workload (CI mode — the test suite
does this so every example runs end-to-end in seconds).
"""

import os
import tempfile

import numpy as np

from neilpy_tpu.backend import enable_compile_cache

enable_compile_cache()

FAST = os.environ.get("EXAMPLE_FAST", "") == "1"
OUT = os.environ.get("OUT_DIR", os.path.join(tempfile.gettempdir(),
                                             "neilpy_tpu_examples"))
os.makedirs(OUT, exist_ok=True)


def out(name):
    return os.path.join(OUT, name)


def use_agg():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def load_sample_dem(return_source=False):
    """Return (Z float32, cellsize, transform[, source]) for the
    notebook DEM.

    Source preference: the real full-res file when available (env
    ``SAMPLE_DEM`` or the reference path) -> the REAL terrain at
    reduced resolution from the GDAL ``.ovr`` pyramid sidecar that
    survives in the mount (level 0 = 2x; level 1 = 4x under
    EXAMPLE_FAST) -> a synthetic stand-in at the golden raster's
    1540x847 dimensions.  ``source`` is one of
    'full' | 'ovr' | 'synthetic'.
    """
    import neilpy_tpu as nt

    def _ret(Z, cs, T, source):
        out = (np.asarray(Z, dtype=np.float32), cs, T)
        return out + (source,) if return_source else out

    candidates = [os.environ.get("SAMPLE_DEM", ""),
                  "/root/reference/sample_data/sample_dem.tif"]
    for fn in candidates:
        if fn and os.path.exists(fn):
            Z, meta = nt.imread(fn)
            cs = float(np.ravel(meta["cellsize"])[0])
            return _ret(Z, cs, meta["transform"], "full")

    ovr = "/root/reference/sample_data/sample_dem.tif.ovr"
    golden = "/root/reference/sample_data/sample_dem_geomorphons.tif"
    if os.path.exists(ovr) and os.path.exists(golden):
        Z, _ = nt.imread(ovr, level=1 if FAST else 0)
        # the .ovr carries no geo tags; the golden raster shares the
        # missing DEM's grid, so scale its georeferencing
        _, mg = nt.imread(golden)
        k = round(mg["height"] / Z.shape[0])
        a = mg["transform"]
        T = nt.Affine(a[0] * k, a[1], a[2], a[3], a[4] * k, a[5])
        cs = float(np.ravel(mg["cellsize"])[0]) * k
        return _ret(Z, cs, T, "ovr")

    H, W = (256, 384) if FAST else (847, 1540)
    rng = np.random.default_rng(7)
    base = rng.normal(size=(H, W)).cumsum(axis=0).cumsum(axis=1)
    base = (base - base.min()) / (base.max() - base.min())
    Z = 243.43 + base * (1899.94 - 243.43)      # aux.xml min/max
    cellsize = 10.0
    T = nt.from_origin(0.0, H * cellsize, cellsize, cellsize)
    return _ret(Z, cellsize, T, "synthetic")
