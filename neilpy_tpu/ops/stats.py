"""Raster spatial statistics and accuracy metrics.

Parity targets (reference neilpy/neilpy.py): gi_formula/gistar_formula
285-294, rasterGi 330-421, rmse 1918-1919, score 2515-2537,
shi_landslides 2544-2553, bdr 2642-2675, chamfer_distance 2679-2718,
hungarian_algorithm 2724-2731, bdr_bootstrap 2735-2745.  Moran's I is
new surface area (BASELINE config 5) built on the same counted-
convolution machinery.

Design: the reference's per-pixel ``generic_filter``
neighbourhood sums (its hottest statistical loop, neilpy.py:380-385)
are *footprint sums*.  Footprints are boolean
masks (generic_filter semantics: no weights, no kernel flip), computed
by the run-decomposed power-of-2 sliding-sum in
``surface.binary_footprint_sum`` — O(rows·log width) whole-array adds
instead of a single-channel convolution.  The normal-distribution tail is evaluated with
``erfc``; significance binning is elementwise.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from .surface import binary_footprint_sum, evans_curvature
from ..core.codes import disk

__all__ = ["gi_formula", "gistar_formula", "rasterGi", "morans_i",
           "local_morans_i", "rmse", "score", "shi_landslides", "bdr",
           "chamfer_distance", "hungarian_algorithm", "bdr_bootstrap"]


def gi_formula(x, n, m, v):
    """Scalar Getis-Ord Gi (parity: neilpy.py:285-289)."""
    x = np.asarray(x, dtype=float)
    k = int(np.sum(np.isfinite(x)))
    return (np.nansum(x) - k * m) / np.sqrt((k * (n - 1 - k) * v) / (n - 2))


def gistar_formula(x, n, m, v):
    """Scalar Getis-Ord Gi* (parity: neilpy.py:291-294)."""
    x = np.asarray(x, dtype=float)
    k = int(np.sum(np.isfinite(x)))
    return (np.nansum(x) - k * m) / np.sqrt((k * (n - k) * v) / (n - 1))


def _norm_sf(z):
    """Standard normal survival function via erfc."""
    return 0.5 * jax.scipy.special.erfc(z / jnp.sqrt(2.0))


def rasterGi(X, footprint=1, mode="nearest", apply_correction=False,
             star=False, global_mean=None, global_var=None,
             global_n=None):
    """Raster Getis-Ord Gi / Gi* hotspot statistics (parity:
    neilpy.py:330-421).

    Returns (Z, P, sig_bin): z-scores, two-tailed p-values, and the
    ArcGIS-style significance bins {0, ±1, ±2, ±3}.

    The neighbourhood count and sum (reference's generic_filter hot
    loop) are computed as exact footprint sums.

    An explicit ``footprint`` array is treated as a boolean MASK
    (``fp != 0``), matching the reference's generic_filter semantics —
    non-uniform weights are NOT applied, and the ``star`` kwarg is
    overridden by whether the mask's centre cell is nonzero.

    ``global_mean``/``global_var``/``global_n`` override the whole-map
    moments and finite-cell count (star path only) so a big mosaic can
    be processed tile-wise while z-scoring against the GLOBAL
    statistics (pipelines/mosaic.py), mirroring ``local_morans_i``'s
    ``mean``/``s2``.
    """
    X = jnp.asarray(X, dtype=jnp.float32)

    if np.isscalar(footprint):
        m = int(footprint)
        size = 2 * m + 1
        fp = np.ones((size, size), dtype=np.float32)
        if not star:
            fp[m, m] = 0
    else:
        fp = np.asarray(footprint).astype(np.float32)
        star = bool(fp[fp.shape[0] // 2, fp.shape[1] // 2] != 0)

    finite = jnp.isfinite(X)
    n = jnp.sum(finite)
    nf = n.astype(jnp.float32)
    if star and global_n is not None:
        nf = jnp.float32(global_n)

    if not star:
        gm = (jnp.nansum(X) - X) / (nf - 1)
        gv = ((jnp.nansum(X ** 2) - X ** 2) / (nf - 1)) - gm ** 2
        gm = jnp.where(finite, gm, jnp.nan)
        gv = jnp.where(finite, gv, jnp.nan)
    else:
        gm = jnp.nanmean(X) if global_mean is None else jnp.float32(global_mean)
        gv = (jnp.nanstd(X) ** 2 if global_var is None
              else jnp.float32(global_var))

    # generic_filter's footprint= is a boolean MASK (no weights, no
    # kernel flip — reference neilpy.py:380-385), so booleanize and
    # use the run-decomposed sum unconditionally
    fp = fp != 0
    w_neighbors = binary_footprint_sum(finite.astype(jnp.float32), fp,
                                       mode=mode)
    w_neighbors = jnp.round(w_neighbors)
    w_neighbors = jnp.where(finite, w_neighbors, jnp.nan)

    nansum_w = binary_footprint_sum(jnp.where(finite, X, 0.0), fp,
                                    mode=mode)
    a = nansum_w - w_neighbors * gm
    if star:
        b = jnp.sqrt((w_neighbors / (nf - 1)) * (nf - w_neighbors) * gv)
    else:
        b = jnp.sqrt((w_neighbors / (nf - 2)) * (nf - 1 - w_neighbors) * gv)
    Z = a / b
    Z = jnp.where(finite, Z, jnp.nan)

    if apply_correction:
        Z = (Z - jnp.nanmean(Z)) / jnp.nanstd(Z)

    P = 2.0 * _norm_sf(jnp.abs(Z))

    sig = jnp.zeros_like(X)
    sig = jnp.where(P < .1, 1.0, sig)
    sig = jnp.where(P < .05, 2.0, sig)
    sig = jnp.where(P < .01, 3.0, sig)
    sig = jnp.where(Z < 0, -sig, sig)
    sig = jnp.where(P >= .1, 0.0, sig)
    sig = jnp.where(finite, sig, jnp.nan)
    return Z, P, sig


def morans_i(X, footprint=1, mode="nearest"):
    """Global Moran's I with a binary footprint weight matrix
    (row-unstandardised).  New surface (BASELINE config 5); computed
    with the same counted convolutions as rasterGi.

    Returns (I, E_I, z_score) under the normality assumption.
    """
    X = jnp.asarray(X, dtype=jnp.float32)
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=np.float32)
        fp[m, m] = 0
    else:
        fp = np.asarray(footprint).astype(np.float32)
        c = fp.shape[0] // 2
        fp = fp.copy()
        fp[c, c] = 0

    finite = jnp.isfinite(X)
    nf = jnp.sum(finite).astype(jnp.float32)
    xbar = jnp.nanmean(X)
    zdev = jnp.where(finite, X - xbar, 0.0)

    fp = fp != 0  # binary weight matrix by definition
    lag = binary_footprint_sum(zdev, fp, mode=mode)
    num = jnp.sum(zdev * lag)
    den = jnp.sum(zdev ** 2)
    # W = total weight: pairs of finite cells within the footprint
    wsum_map = binary_footprint_sum(finite.astype(jnp.float32), fp,
                                    mode=mode)
    W = jnp.sum(jnp.where(finite, wsum_map, 0.0))
    I = (nf / W) * (num / den)
    E_I = -1.0 / (nf - 1)
    # normality-assumption variance (Cliff & Ord)
    S0 = W
    S1 = 2.0 * W  # binary symmetric: (1/2) sum (w_ij + w_ji)^2 = 2 W
    S2 = jnp.sum(jnp.where(finite, (2.0 * wsum_map) ** 2, 0.0))
    var_I = ((nf ** 2 * S1 - nf * S2 + 3.0 * S0 ** 2)
             / ((nf ** 2 - 1.0) * S0 ** 2)) - E_I ** 2
    z = (I - E_I) / jnp.sqrt(var_I)
    return I, E_I, z


def local_morans_i(X, footprint=1, mode="nearest", mean=None, s2=None):
    """Local Moran's I (Anselin LISA) per cell with binary weights.

    ``mean``/``s2`` override the global moments — required when a big
    mosaic is processed tile-wise and each tile must z-score against
    the *global* statistics (pipelines/mosaic.py)."""
    X = jnp.asarray(X, dtype=jnp.float32)
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=np.float32)
        fp[m, m] = 0
    else:
        fp = np.asarray(footprint).astype(np.float32)
    finite = jnp.isfinite(X)
    nf = jnp.sum(finite).astype(jnp.float32)
    xbar = jnp.nanmean(X) if mean is None else jnp.float32(mean)
    zdev = jnp.where(finite, X - xbar, 0.0)
    if s2 is None:
        s2 = jnp.sum(zdev ** 2) / nf
    else:
        s2 = jnp.float32(s2)
    fp = fp != 0  # binary weight matrix by definition
    lag = binary_footprint_sum(zdev, fp, mode=mode)
    I = (zdev / s2) * lag
    return jnp.where(finite, I, jnp.nan)


def rmse(X):
    """sqrt(nansum(X^2)/N) (parity: neilpy.py:1918-1919)."""
    X = jnp.asarray(X)
    return jnp.sqrt(jnp.nansum(X ** 2) / X.size)


def score(A, B, k=100000, mask=None, seed=None):
    """Sampled classification metrics: Cohen's kappa, confusion matrix,
    F1, accuracy (parity: neilpy.py:2515-2537)."""
    from sklearn.metrics import (cohen_kappa_score, confusion_matrix,
                                 f1_score, accuracy_score)
    A = np.asarray(A)
    B = np.asarray(B)
    if mask is None:
        A, B = A.flatten(), B.flatten()
    else:
        A, B = A[mask].flatten(), B[mask].flatten()
    if k > len(A):
        k = len(A)
    rng = np.random.default_rng(seed)
    s = rng.choice(len(A), k, replace=True)
    return {"cohen_kappa_score": cohen_kappa_score(A[s], B[s]),
            "confusion_matrix": confusion_matrix(A[s], B[s]),
            "f1_score": f1_score(A[s], B[s]),
            "accuracy_score": accuracy_score(A[s], B[s])}


def shi_landslides(dem, radii, cellsize=1):
    """Landslide candidate map: Gi* of tangential curvature over
    multiple disk radii (parity: neilpy.py:2544-2553).

    The reference forks a joblib pool; here each radius is one jitted
    convolution-based Gi* on device, so the 'parallelism' is simply the
    device's own throughput (and radii could be vmapped if ever hot).
    """
    k, kprof, kplan, ktan, klong, kcross = evans_curvature(dem, cellsize)
    sig_bins = []
    for radius in radii:
        _, _, sig = rasterGi(ktan, disk(radius), star=True)
        sig_bins.append(sig)
    return jnp.any(jnp.stack(sig_bins) < -2, axis=0)


# ----------------------------------------------------------------------
# Point-set comparison / regression metrics (host-side analytics)
# ----------------------------------------------------------------------
def bdr(XY, AB):
    """Euclidean bidimensional regression, Friedman & Kohler 2003
    (parity: neilpy.py:2642-2675)."""
    from scipy import stats as sstats
    XY = np.asarray(XY, dtype=float)
    AB = np.asarray(AB, dtype=float)
    X, Y = XY[:, 0], XY[:, 1]
    A, B = AB[:, 0], AB[:, 1]

    def ssq(v):
        return np.sum((v - np.mean(v)) ** 2)

    denom = ssq(X) + ssq(Y)
    beta1 = (np.sum((X - X.mean()) * (A - A.mean()))
             + np.sum((Y - Y.mean()) * (B - B.mean()))) / denom
    beta2 = (np.sum((X - X.mean()) * (B - B.mean()))
             - np.sum((Y - Y.mean()) * (A - A.mean()))) / denom
    scale = np.hypot(beta1, beta2)
    theta = np.rad2deg(np.arctan2(beta2, beta1))
    alpha1 = A.mean() - beta1 * X.mean() + beta2 * Y.mean()
    alpha2 = B.mean() - beta2 * X.mean() - beta1 * Y.mean()
    aPrime = alpha1 + beta1 * X - beta2 * Y
    bPrime = alpha2 + beta2 * X + beta1 * Y
    resid = np.sum((A - aPrime) ** 2 + (B - bPrime) ** 2)
    rsquare = 1 - resid / (ssq(A) + ssq(B))
    D = np.sqrt(resid)
    Dmax = np.sqrt(ssq(A) + ssq(B))
    DI = np.sqrt(max(1 - rsquare, 0.0))
    # Nakaya F; a perfect fit (rsquare == 1) gives F = inf, P = 0
    with np.errstate(divide="ignore"):
        F = ((2 * len(A) - 4) / 2) * np.divide(rsquare, 1 - rsquare)
    P = 1 - sstats.f.cdf(F, 2, 2 * len(A) - 4)
    return {"beta1": beta1, "beta2": beta2, "alpha1": alpha1,
            "alpha2": alpha2, "scale": scale, "theta": theta,
            "aPrime": aPrime, "bPrime": bPrime, "rsquare": rsquare,
            "D": D, "Dmax": Dmax, "DI": DI, "F": F, "P": P}


def chamfer_distance(x, y, metric="l2", direction="bi"):
    """Chamfer distance between point clouds (parity:
    neilpy.py:2679-2718), via sklearn KD-trees."""
    from sklearn.neighbors import NearestNeighbors

    def one_way(src, dst):
        nn = NearestNeighbors(n_neighbors=1, leaf_size=1,
                              algorithm="kd_tree", metric=metric).fit(dst)
        return float(np.mean(nn.kneighbors(src)[0]))

    if direction == "y_to_x":
        return one_way(y, x)
    if direction == "x_to_y":
        return one_way(x, y)
    if direction == "bi":
        return one_way(y, x) + one_way(x, y)
    raise ValueError("Invalid direction type. Supported types: "
                     "'y_to_x', 'x_to_y', 'bi'")


def hungarian_algorithm(XY, AB):
    """Optimal assignment between point sets (parity:
    neilpy.py:2724-2731)."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial.distance import cdist
    cost = cdist(XY, AB)
    rows, cols = linear_sum_assignment(cost)
    return rows, cols, cost[rows, cols]


def bdr_bootstrap(XY, AB, k=10000, seed=None):
    """Bootstrap r^2/DI under random correspondence + Hungarian
    matching (parity: neilpy.py:2735-2745)."""
    rng = np.random.default_rng(seed)
    rsq = np.zeros(k)
    DI = np.zeros(k)
    XY = np.asarray(XY)
    AB = np.asarray(AB)
    for i in range(k):
        idx = rng.choice(len(AB), len(XY), replace=False)
        ABs = AB[idx, :]
        _, col, _ = hungarian_algorithm(XY, ABs)
        res = bdr(XY, ABs[col, :])
        rsq[i] = res["rsquare"]
        DI[i] = res["DI"]
    return rsq, DI
