"""Surface derivative stencils: slope, aspect, hillshade, curvatures.

All functions are pure jnp graphs built from the shared shift/gradient
primitives in ``core.shift`` — element-wise algebra over a handful of
shifted copies, which XLA fuses into a single memory-bound pass.  They
run identically on the GPU, on the CPU backend, and inside ``shard_map``
halo-tiled execution (halo radius 1, or ``lookup_pixels`` for
``scaled_morphometry``).

Parity targets (reference neilpy/neilpy.py): esri_slope 434-449, slope
456-466, aspect 471-484, curvature 487-488, esri_curvature 520-574,
zevenbergen_and_thorne_curvature 596-667, evans_curvature 671-737,
wilson_gallant_curvature 753-806, hillshade 814-824,
multiple_illumination 830-842, pssm 846-867, z_factor 871-880,
triangle_height/vip_score 1818-1845, std 2039-2047, reduce_peaks
2056-2087, topographic_position_index 2098-2124, scaled_morphometry
2472-2510.
"""

from __future__ import annotations


import jax
import numpy as np
import jax.numpy as jnp

from ..core.shift import ashift, gradient2d, pad_edge, pad_reflect
from ..core.codes import disk, distance_kernel

__all__ = [
    "esri_slope", "slope", "aspect", "curvature", "esri_curvature",
    "zevenbergen_and_thorne_curvature", "evans_curvature",
    "wilson_gallant_curvature", "hillshade", "multiple_illumination",
    "pssm", "z_factor", "triangle_height", "vip_score", "std",
    "reduce_peaks", "topographic_position_index", "scaled_morphometry",
    "convolve2d_nearest", "binary_footprint_sum",
]


# ----------------------------------------------------------------------
# Convolution helper: footprint correlation with edge-replicate padding
# (scipy.ndimage.convolve mode='nearest').  Lowered to lax.conv at
# HIGHEST precision: a float32 convolution may otherwise run in TF32 on
# the GPU, which keeps ~3 decimal digits (std's E[x^2] trick and TPI
# difference large near-equal terms).
# ----------------------------------------------------------------------
def convolve2d_nearest(X, kernel, mode="nearest"):
    X = jnp.asarray(X, dtype=jnp.float32)
    k = np.asarray(kernel, dtype=np.float32)
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    if mode == "nearest":
        Xp = pad_edge(X, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    elif mode == "reflect":
        Xp = pad_reflect(X, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    else:
        raise ValueError(f"unsupported mode {mode}")
    # scipy.ndimage.convolve flips the kernel; lax.conv correlates.
    kflip = jnp.asarray(k[::-1, ::-1])
    out = jax.lax.conv_general_dilated(
        Xp[None, None, :, :], kflip[None, None, :, :],
        window_strides=(1, 1), padding="VALID",
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[0, 0]


def binary_footprint_sum(X, footprint, mode="nearest"):
    """Neighbourhood sum over a BINARY footprint with edge-replicate
    (or reflect) padding — exact ``generic_filter``-style correlation
    semantics (no kernel flip; footprints are taken as positioned).

    Decomposes the footprint into horizontal runs per row and builds
    each run's sliding sum from power-of-2 partials: O(rows * log
    width) whole-array adds instead of the O(rows * width) MACs of
    the conv lowering, which is a poor fit for single-channel spatial
    kernels."""
    X = jnp.asarray(X, dtype=jnp.float32)
    fp = np.asarray(footprint) != 0
    kh, kw = fp.shape
    ph, pw = kh // 2, kw // 2
    H, W = X.shape
    if mode == "nearest":
        Xp = pad_edge(X, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    elif mode == "reflect":
        Xp = pad_reflect(X, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    else:
        raise ValueError(f"unsupported mode {mode}")

    # runs per footprint row: [(dr, c0, width), ...]
    runs = []
    for dr in range(kh):
        row = fp[dr]
        c = 0
        while c < kw:
            if not row[c]:
                c += 1
                continue
            c0 = c
            while c < kw and row[c]:
                c += 1
            runs.append((dr, c0, c - c0))
    if not runs:
        return jnp.zeros((H, W), dtype=jnp.float32)

    # power-of-2 column partial sums built ONCE on the full padded
    # array and shared by every row's runs
    wmax = max(w for _, _, w in runs)
    partial = {1: Xp}
    k = 1
    while k * 2 <= wmax:
        a = partial[k]
        n = a.shape[1]
        partial[2 * k] = a[:, : n - k] + a[:, k:]
        k *= 2

    out = jnp.zeros((H, W), dtype=jnp.float32)
    for dr, c0, wlen in runs:
        # combine the binary decomposition of wlen starting at col c0
        off = c0
        k = 1 << (wlen.bit_length() - 1)
        acc = None
        while k >= 1:
            if wlen & k:
                piece = partial[k][dr:dr + H, off:off + W]
                acc = piece if acc is None else acc + piece
                off += k
            k //= 2
        out = out + acc
    return out


# ----------------------------------------------------------------------
# Slope / aspect / hillshade
# ----------------------------------------------------------------------
def slope(Z, cellsize=1, z_factor=1, return_as="degrees"):
    """Gradient-based slope (neilpy.py:456-466)."""
    if return_as not in ("degrees", "radians", "percent"):
        print("return_as", return_as, "is not supported.")
        return None
    gy, gx = gradient2d(jnp.asarray(Z), cellsize / z_factor)
    S = jnp.sqrt(gx ** 2 + gy ** 2)
    if return_as in ("degrees", "radians"):
        S = jnp.arctan(S)
        if return_as == "degrees":
            S = jnp.rad2deg(S)
    return S


def esri_slope(Z, cellsize=1, z_factor=1, return_as="degrees"):
    """ESRI 3x3 Horn slope (neilpy.py:434-449), vectorised: the
    per-pixel generic_filter is replaced by eight shifted reads with
    reflect padding (generic_filter mode='reflect')."""
    Z = jnp.asarray(Z, dtype=jnp.float32)
    P = pad_reflect(Z, 1)
    n = {}
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            n[(dr, dc)] = P[1 + dr: P.shape[0] - 1 + dr,
                            1 + dc: P.shape[1] - 1 + dc]
    dz_dx = ((n[(-1, 1)] + 2 * n[(0, 1)] + n[(1, 1)])
             - (n[(-1, -1)] + 2 * n[(0, -1)] + n[(1, -1)])) / 8.0
    dz_dy = ((n[(1, -1)] + 2 * n[(1, 0)] + n[(1, 1)])
             - (n[(-1, -1)] + 2 * n[(-1, 0)] + n[(-1, 1)])) / 8.0
    S = jnp.sqrt(dz_dx ** 2 + dz_dy ** 2)
    if cellsize != 1:
        S = S / cellsize
    if z_factor != 1:
        S = z_factor * S
    if return_as == "degrees":
        S = jnp.rad2deg(jnp.arctan(S))
    return S


def aspect(Z, return_as="degrees", flat_as="nan"):
    """Gradient-based compass aspect (neilpy.py:471-484)."""
    if return_as not in ("degrees", "radians"):
        print("return_as", return_as, "is not supported.")
        return None
    gy, gx = gradient2d(jnp.asarray(Z))
    A = jnp.arctan2(gy, -gx)
    A = jnp.pi / 2 - A
    A = jnp.where(A < 0, A + 2 * jnp.pi, A)
    if return_as == "degrees":
        A = jnp.rad2deg(A)
    if flat_as == "nan":
        flat_as = jnp.nan
    return jnp.where((gx == 0) & (gy == 0), flat_as, A)


def hillshade(Z, cellsize=1, z_factor=1, zenith=45, azimuth=315,
              return_uint8=True):
    """ESRI hillshade from gradient slope/aspect (neilpy.py:814-824)."""
    zen = jnp.deg2rad(jnp.asarray(zenith, dtype=jnp.float32))
    azi = jnp.deg2rad(jnp.asarray(azimuth, dtype=jnp.float32))
    S = slope(Z, cellsize=cellsize, z_factor=z_factor, return_as="radians")
    A = aspect(Z, return_as="radians", flat_as=0)
    H = (jnp.cos(zen) * jnp.cos(S)
         + jnp.sin(zen) * jnp.sin(S) * jnp.cos(azi - A))
    H = jnp.where(H < 0, 0.0, H)
    if return_uint8:
        H = jnp.round(255.0 * H).astype(jnp.uint8)
    return H


def multiple_illumination(Z, cellsize=1, z_factor=1,
                          zeniths=np.array([45]), azimuths=4):
    """Max-combined hillshade over a zenith x azimuth grid
    (neilpy.py:830-842)."""
    if np.isscalar(azimuths):
        azimuths = np.arange(0, 360, 360 / azimuths)
    if np.isscalar(zeniths):
        step = 90 / (zeniths + 1)
        zeniths = np.arange(step, 90, step)
    H = jnp.zeros(jnp.shape(Z))
    for zen in zeniths:
        for azi in azimuths:
            H1 = hillshade(Z, cellsize=cellsize, z_factor=z_factor,
                           zenith=zen, azimuth=azi)
            H = jnp.maximum(H, H1.astype(H.dtype))
    return H.astype(jnp.uint8)


def pssm(Z, cellsize=1, ve=2.3, reverse=False, apply_colormap=True):
    """Perceptually Scaled Slope Map / bonemap (neilpy.py:846-867).

    Returns uint8 class values, or RGBA float via the matplotlib
    ``bone``/``bone_r`` colormap when ``apply_colormap``.
    """
    Z = jnp.asarray(Z, dtype=jnp.float32)
    gy, gx = gradient2d(Z, cellsize)
    S = jnp.sqrt(gx ** 2 + gy ** 2)
    P = jnp.rad2deg(jnp.arctan(ve * S)) / 90.0
    P = jnp.round(255 * P).astype(jnp.uint8)
    if apply_colormap:
        import matplotlib.pyplot as plt
        cmap = plt.cm.bone if reverse else plt.cm.bone_r
        return cmap(np.asarray(P))
    return P


def z_factor(latitude):
    """Latitude-dependent z-factor for degree-referenced DEMs
    (neilpy.py:871-880)."""
    latitude = jnp.deg2rad(jnp.asarray(latitude))
    a = 6378137.0
    b = 6356752.3
    numer = (a ** 4) * jnp.cos(latitude) ** 2 + (b ** 4) * jnp.sin(latitude) ** 2
    denom = (a * jnp.cos(latitude)) ** 2 + (b * jnp.sin(latitude)) ** 2
    return 1.0 / (jnp.pi / 180 * jnp.cos(latitude) * jnp.sqrt(numer / denom))


# ----------------------------------------------------------------------
# Curvatures.  Cell naming follows Zevenbergen & Thorne: Z1..Z9 from the
# upper-left, Z5 = center.  NaN conventions are replicated per variant.
# ----------------------------------------------------------------------
def _neighbors_zt(X):
    """Z1..Z9 (minus center) via ashift, reference direction mapping
    (neilpy.py:528-535)."""
    return dict(Z1=ashift(X, 0), Z2=ashift(X, 1), Z3=ashift(X, 2),
                Z4=ashift(X, 7), Z6=ashift(X, 3), Z7=ashift(X, 6),
                Z8=ashift(X, 5), Z9=ashift(X, 4))


def _fill_nan_with_center(n, X):
    return {k: jnp.where(jnp.isnan(v), X, v) for k, v in n.items()}


def _fill_nan_wilson_gallant(n, X):
    """Wilson & Gallant eq. 3.8 reflection fill, replicated in the
    reference's sequential order (neilpy.py:615-622): opposite pairs
    (Z1,Z9),(Z2,Z8),(Z3,Z7),(Z4,Z6); later fills see earlier results."""
    order = [("Z1", "Z9"), ("Z2", "Z8"), ("Z3", "Z7"), ("Z4", "Z6"),
             ("Z6", "Z4"), ("Z7", "Z3"), ("Z8", "Z2"), ("Z9", "Z1")]
    n = dict(n)
    for a, b in order:
        n[a] = jnp.where(jnp.isnan(n[a]), 2 * X - n[b], n[a])
    return n


def curvature(X, cellsize=1):
    """-100 x Laplacian, ESRI-equivalent general curvature
    (neilpy.py:487-488; ndi.laplace correlates [1,-2,1] per axis with
    reflect boundary)."""
    X = jnp.asarray(X, dtype=jnp.float32) / cellsize
    P = pad_reflect(X, 1)
    lap = (P[:-2, 1:-1] + P[2:, 1:-1] + P[1:-1, :-2] + P[1:-1, 2:]
           - 4.0 * X)
    return -100.0 * lap


def esri_curvature(X, cellsize=1):
    """ESRI planar curvature triple (K, K_plan, K_profile)
    (neilpy.py:520-574).  NaN neighbours take the center value."""
    X = jnp.asarray(X)
    L = cellsize
    n = _fill_nan_with_center(_neighbors_zt(X), X)
    Z1, Z2, Z3, Z4 = n["Z1"], n["Z2"], n["Z3"], n["Z4"]
    Z6, Z7, Z8, Z9 = n["Z6"], n["Z7"], n["Z8"], n["Z9"]
    D = ((Z4 + Z6) / 2 - X) / L ** 2
    E = ((Z2 + Z8) / 2 - X) / L ** 2
    F = (-Z1 + Z3 + Z7 - Z9) / (4 * L ** 2)
    G = (-Z4 + Z6) / (2 * L)
    H = (Z2 - Z8) / (2 * L)
    K = -200 * (D + E)
    denom = G ** 2 + H ** 2
    K_plan = 200 * (D * H ** 2 + E * G ** 2 - F * G * H) / denom
    K_plan = jnp.where(jnp.isnan(K_plan), 0.0, K_plan)
    K_profile = -200 * (D * G ** 2 + E * H ** 2 + F * G * H) / denom
    K_profile = jnp.where(jnp.isnan(K_profile), 0.0, K_profile)
    return K, K_plan, K_profile


def zevenbergen_and_thorne_curvature(X, cellsize=1):
    """Six Z&T curvatures (K, profile, plan, tan, long, cross)
    (neilpy.py:596-667)."""
    X = jnp.asarray(X)
    L = cellsize
    n = _fill_nan_wilson_gallant(_neighbors_zt(X), X)
    Z1, Z2, Z3, Z4 = n["Z1"], n["Z2"], n["Z3"], n["Z4"]
    Z6, Z7, Z8, Z9 = n["Z6"], n["Z7"], n["Z8"], n["Z9"]
    D = ((Z4 + Z6) / 2 - X) / L ** 2
    E = ((Z2 + Z8) / 2 - X) / L ** 2
    F = (-Z1 + Z3 + Z7 - Z9) / (4 * L ** 2)
    G = (-Z4 + Z6) / (2 * L)
    H = (Z2 - Z8) / (2 * L)
    P = G ** 2 + H ** 2
    Q = P + 1
    K = 2 * (D + E)
    K_cross = 2 * (D * H ** 2 + E * G ** 2 - F * G * H) / P
    K_cross = jnp.where(jnp.isnan(K_cross), 0.0, K_cross)
    K_long = -2 * (D * G ** 2 + E * H ** 2 + F * G * H) / P
    K_long = jnp.where(jnp.isnan(K_long), 0.0, K_long)
    K_tan = -(D * H ** 2 - 2 * F * G * H + E * G ** 2) / (P * Q ** 0.5)
    K_profile = (D * G ** 2 + 2 * F * G * H + E * H ** 2) / (P * Q ** 1.5)
    # Note: reference uses D*E**2 in the first term (neilpy.py:662);
    # replicated verbatim for parity.
    K_plan = -(D * E ** 2 - 2 * F * G * H + E * G ** 2) / (P ** 1.5)
    return K, K_profile, K_plan, K_tan, K_long, K_cross


def _evans_terms(X, z, L):
    """Wood (1991) quadratic-fit terms from a 3x3 (or scaled)
    neighbourhood dict z (keys z1..z9 minus center)."""
    A = ((z["Z1"] + z["Z3"] + z["Z4"] + z["Z6"] + z["Z7"] + z["Z9"])
         / (6 * L ** 2) - (z["Z2"] + X + z["Z8"]) / (3 * L ** 2))
    B = ((z["Z1"] + z["Z2"] + z["Z3"] + z["Z7"] + z["Z8"] + z["Z9"])
         / (6 * L ** 2) - (z["Z4"] + X + z["Z6"]) / (3 * L ** 2))
    C = (z["Z3"] + z["Z7"] - z["Z1"] - z["Z9"]) / (4 * L ** 2)
    D = (z["Z3"] + z["Z6"] + z["Z9"] - z["Z1"] - z["Z4"] - z["Z7"]) / (6 * L)
    E = (z["Z1"] + z["Z2"] + z["Z3"] - z["Z7"] - z["Z8"] - z["Z9"]) / (6 * L)
    return A, B, C, D, E


def evans_curvature(X, cellsize=1):
    """Evans/Wood six curvatures (neilpy.py:671-737)."""
    X = jnp.asarray(X)
    L = cellsize
    n = _fill_nan_wilson_gallant(_neighbors_zt(X), X)
    A, B, C, D, E = _evans_terms(X, n, L)
    K = -2 * (A + B)
    P = D ** 2 + E ** 2
    Q = P + 1
    K_profile = -(A * D ** 2 + 2 * C * D * E + B * E ** 2) / (P * Q ** 1.5)
    K_cross = -2 * (B * D ** 2 + A * E ** 2 - C * D * E) / P
    K_long = -2 * (A * D ** 2 + B * E ** 2 + C * D * E) / P
    K_tan = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / (P * Q ** 0.5)
    K_plan = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / P ** 1.5
    finite = jnp.isfinite(X)
    fix = lambda M: jnp.where(jnp.isnan(M) & finite, 0.0, M)
    return (K, fix(K_profile), fix(K_plan), fix(K_tan), fix(K_long),
            fix(K_cross))


def wilson_gallant_curvature(X, cellsize=1):
    """Wilson & Gallant curvatures (neilpy.py:753-806).

    The reference calls ``ashift(X, 8)`` / ``ashift(X, 9)`` for Z7/Z8
    which fall through every branch and return an *unshifted copy*; our
    ``ashift`` replicates that quirk, so outputs match the reference's
    actual (latently buggy) behaviour.
    """
    X = jnp.asarray(X)
    H = cellsize
    Z1 = ashift(X, 2)
    Z2 = ashift(X, 3)
    Z3 = ashift(X, 4)
    Z4 = ashift(X, 5)
    Z5 = ashift(X, 6)
    Z6 = ashift(X, 7)
    Z7 = ashift(X, 8)   # reference quirk: unshifted copy
    Z8 = ashift(X, 9)   # reference quirk: unshifted copy
    Z9 = X
    pairs = [("Z1", "Z5"), ("Z2", "Z6"), ("Z3", "Z7"), ("Z4", "Z8"),
             ("Z5", "Z1"), ("Z6", "Z2"), ("Z7", "Z3"), ("Z8", "Z4")]
    zs = dict(Z1=Z1, Z2=Z2, Z3=Z3, Z4=Z4, Z5=Z5, Z6=Z6, Z7=Z7, Z8=Z8)
    for a, b in pairs:
        zs[a] = jnp.where(jnp.isnan(zs[a]), 2 * Z9 - zs[b], zs[a])
    Z1, Z2, Z3, Z4 = zs["Z1"], zs["Z2"], zs["Z3"], zs["Z4"]
    Z5, Z6, Z7, Z8 = zs["Z5"], zs["Z6"], zs["Z7"], zs["Z8"]
    ZX = (Z2 - Z6) / (2 * H)
    ZY = (Z8 - Z4) / (2 * H)
    ZXX = (Z2 - 2 * Z9 + Z6) / H ** 2
    ZYY = (Z8 - 2 * Z9 + Z4) / H ** 2
    # Reference formula literally reads ``/ 4*H**2`` i.e. *(H**2)/4;
    # replicated verbatim (neilpy.py:787).
    ZXY = (-Z7 + Z1 + Z5 - Z3) / 4 * H ** 2
    P = ZX ** 2 + ZY ** 2
    Q = P + 1
    Kc = (ZXX * ZY ** 2 - 2 * ZXY * ZX * ZY + ZYY * ZX ** 2) / P ** 1.5
    Kp = (ZXX * ZX ** 2 + 2 * ZXY * ZX * ZY + ZYY * ZY ** 2) / (P * Q ** 1.5)
    Kt = (ZXX * ZX ** 2 + 2 * ZXY * ZX * ZY + ZYY * ZY ** 2) / (P * Q ** 0.5)
    K = ZXX ** 2 + 2 * ZXY ** 2 + ZYY ** 2
    return K, Kp, Kc, Kt


def scaled_morphometry(X, cellsize=1, lookup_pixels=1):
    """Evans/Wood morphometry at an arbitrary lookup distance
    (neilpy.py:2472-2510).  Returns dict with aspect A, slope S and six
    curvatures."""
    X = jnp.asarray(X)
    L = cellsize * lookup_pixels
    n = dict(Z1=ashift(X, 0, lookup_pixels), Z2=ashift(X, 1, lookup_pixels),
             Z3=ashift(X, 2, lookup_pixels), Z4=ashift(X, 7, lookup_pixels),
             Z6=ashift(X, 3, lookup_pixels), Z7=ashift(X, 6, lookup_pixels),
             Z8=ashift(X, 5, lookup_pixels), Z9=ashift(X, 4, lookup_pixels))
    A, B, C, D, E = _evans_terms(X, n, L)
    P = D ** 2 + E ** 2
    Q = P + 1
    SM = {}
    SM["A"] = jnp.mod(270 - jnp.rad2deg(jnp.arctan2(E, D)), 360)
    SM["S"] = jnp.rad2deg(jnp.arctan(jnp.sqrt(P)))
    SM["K"] = -2 * (A + B)
    SM["K_profile"] = -(A * D ** 2 + 2 * C * D * E + B * E ** 2) / (P * Q ** 1.5)
    SM["K_cross"] = -2 * (B * D ** 2 + A * E ** 2 - C * D * E) / P
    SM["K_long"] = -2 * (A * D ** 2 + B * E ** 2 + C * D * E) / P
    SM["K_tan"] = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / (P * Q ** 0.5)
    SM["K_plan"] = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / P ** 1.5
    return SM


# ----------------------------------------------------------------------
# VIP, windowed std, peak reduction, TPI
# ----------------------------------------------------------------------
def triangle_height(h0, h1, x_dist=1):
    """Point-to-chord triangle height via the cross product
    (neilpy.py:1818-1830)."""
    h0 = jnp.asarray(h0)
    h1 = jnp.asarray(h1)
    cp = jnp.abs(-x_dist * h1 - x_dist * h0)
    base = jnp.sqrt((2 * x_dist) ** 2 + (h1 - h0) ** 2)
    return cp / base


def vip_score(Z, cellsize=1):
    """Very-Important-Points score: mean triangle height over the four
    opposing-neighbour axes (neilpy.py:1832-1845)."""
    Z = jnp.asarray(Z)
    dlist = (2.0 ** 0.5, 1.0)
    heights = jnp.zeros(Z.shape, dtype=jnp.float32)
    for direction in range(4):
        dist = dlist[direction % 2]
        h0 = ashift(Z, direction) - Z
        h1 = ashift(Z, direction + 4) - Z
        heights = heights + triangle_height(h0, h1, dist * cellsize)
    return heights / 4.0


def _uniform_correlate(X, kernel, mode="nearest"):
    """Route a correlation through the fast run-decomposed sum when
    the kernel is a uniformly-weighted symmetric footprint (c * binary
    with point-symmetric support — then flip == identity); weighted
    kernels keep the conv lowering."""
    k = np.asarray(kernel, dtype=np.float64)
    nz = k[k != 0]
    if (nz.size and np.all(nz == nz[0])
            and np.array_equal(k, k[::-1, ::-1])):
        return binary_footprint_sum(X, k != 0, mode=mode) * float(nz[0])
    return convolve2d_nearest(X, kernel, mode=mode)


def std(X, strel):
    """Convolution-based windowed standard deviation
    (neilpy.py:2039-2047)."""
    X = jnp.asarray(X, dtype=jnp.float32)
    s = np.asarray(strel, dtype=np.float32)
    ssum = float(s.sum())
    Xsum = _uniform_correlate(X, s)
    Xss = _uniform_correlate(X ** 2, s)
    Xm = Xsum / ssum
    V = (Xss - 2 * Xm * Xsum + ssum * Xm ** 2) / ssum
    V = jnp.where(V < 0, 0.0, V)
    return jnp.sqrt(V)


def std2(X, strel):
    """Windowed RMS deviation from the local mean — the reference's
    older std prototype (neilpy.py:2051-2053), made runnable.

    The reference body is dead code (references an undefined ``Z`` and
    returns nothing; its own comment calls it "not correct, but leaving
    for further re-examination").  This computes what that body wrote,
    with the obvious Z->X fix and a return: sqrt of the windowed mean
    of (local_mean - X)^2.  Note this is NOT the windowed standard
    deviation — each squared deviation is taken against its *own*
    window's mean; prefer :func:`std`.  Exported for inventory
    completeness only.
    """
    X = jnp.asarray(X, dtype=jnp.float32)
    s = np.asarray(strel, dtype=np.float32)
    s = s / s.sum()
    M = _uniform_correlate(X, s)
    return jnp.sqrt(_uniform_correlate((M - X) ** 2, s))


def reduce_peaks(Z, radius, blend_rate=2, kernel_rate="auto"):
    """Distance-kernel smoothing blended by inverse local variability
    (neilpy.py:2056-2087)."""
    from ..core.grid import normalize
    if kernel_rate == "auto":
        kernel_rate = 1 / blend_rate
    strel = distance_kernel(radius, method="distance")
    strel = 1 - (strel / np.max(strel))
    strel = strel ** kernel_rate
    Z = jnp.asarray(Z, dtype=jnp.float32)
    M = convolve2d_nearest(Z, strel / strel.sum())
    STD = std(Z - M, strel)
    V = (1 - normalize(STD)) ** blend_rate
    return (1 - V) * M + V * Z


def topographic_position_index(X, radius=1, standardize=True):
    """TPI: value minus ring-mean (neilpy.py:2098-2124)."""
    X = jnp.asarray(X, dtype=jnp.float32)
    if radius == 1:
        strel = np.ones((3, 3), dtype=np.float64)
    else:
        strel = disk(radius).astype(np.float64)
    strel[radius, radius] = 0
    strel = strel / strel.sum()
    mean = _uniform_correlate(X, strel)
    result = X - mean
    if standardize:
        # Reference formula replicated verbatim (flagged as suspect by
        # the author at neilpy.py:2118-2120).
        sd = jnp.sqrt(jnp.mean(_uniform_correlate(X ** 2, strel))
                      - jnp.mean(result) ** 2)
        result = result / sd
    return result
