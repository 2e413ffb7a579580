"""Independent numpy re-implementations of reference semantics used as
test oracles.

These are written from the algorithm descriptions (Yokoyama openness,
Horn slope, Z&T curvature, D'Errico spring inpainting, ...) and from
the behavioural notes in SURVEY.md; they serve as slow, trusted oracles
for the jitted device kernels.  scipy/sklearn are allowed here (tests
only).
"""

import numpy as np


def np_ashift(surface, direction, n=1):
    s = surface.copy()
    if direction == 0:
        s[n:, n:] = s[0:-n, 0:-n]
    elif direction == 1:
        s[n:, :] = s[0:-n, :]
    elif direction == 2:
        s[n:, 0:-n] = s[0:-n, n:]
    elif direction == 3:
        s[:, 0:-n] = s[:, n:]
    elif direction == 4:
        s[0:-n, 0:-n] = s[n:, n:]
    elif direction == 5:
        s[0:-n, :] = s[n:, :]
    elif direction == 6:
        s[0:-n, n:] = s[n:, 0:-n]
    elif direction == 7:
        s[:, n:] = s[:, 0:-n]
    return s


def np_skyview_factor(Z, cellsize=1, lookup_pixels=1):
    """Literal replication of the reference's skyview loop
    (neilpy.py:1360-1384): INCREMENTAL single-pixel ashift accumulation
    (the shifted value freezes at the ray's exit elevation while the
    distance keeps growing) + nanmax + clip at 0."""
    sum_matrix = np.zeros_like(Z, dtype=np.float64)
    dlist = np.array([np.sqrt(2), 1.0])
    for direction in range(8):
        max_angles = np.zeros_like(Z, dtype=np.float64)
        z_shift = Z.copy().astype(np.float64)
        for L in range(1, lookup_pixels + 1):
            dist = cellsize * L * dlist[direction % 2]
            z_shift = np_ashift(z_shift, direction, 1)
            these = np.clip(np.arctan((z_shift - Z) / dist), 0, np.inf)
            max_angles = np.nanmax(np.stack((max_angles, these)), axis=0)
        sum_matrix += np.sin(max_angles)
    return 1 - sum_matrix / 8


def np_openness(Z, cellsize=1, lookup_pixels=1, neighbors=range(8)):
    nb = list(neighbors)
    nr, nc = Z.shape
    opn = np.inf * np.ones((len(nb), nr, nc))
    dlist = np.array([np.sqrt(2), 1])
    for L in range(1, lookup_pixels + 1):
        for i, d in enumerate(nb):
            dist = cellsize * L * dlist[d % 2]
            ang = (np.pi / 2) - np.arctan((np_ashift(Z, d, L) - Z) / dist)
            layer = opn[i]
            better = ang < layer
            layer[better] = ang[better]
            opn[i] = layer
    return np.rad2deg(np.mean(opn, 0))


def np_count_openness(Z, cellsize, lookup_pixels, threshold_angle,
                      fast=False, how_fast=20, return_margin=False):
    num_pos = np.zeros(Z.shape, dtype=np.uint8)
    num_neg = np.zeros(Z.shape, dtype=np.uint8)
    margin = np.full(Z.shape, np.inf)
    ladder = (np_progressive_window(lookup_pixels, how_fast) if fast
              else range(1, lookup_pixels + 1))
    for i in range(8):
        O = _np_openness_ladder(Z, cellsize, ladder, i)
        O = O - _np_openness_ladder(-Z, cellsize, ladder, i)
        num_pos[O > threshold_angle] += 1
        num_neg[O < -threshold_angle] += 1
        margin = np.minimum(margin, np.minimum(
            np.abs(O - threshold_angle), np.abs(O + threshold_angle)))
    if return_margin:
        return num_pos, num_neg, margin
    return num_pos, num_neg


def _np_openness_ladder(Z, cellsize, ladder, d):
    """Single-direction openness over an explicit L ladder (degrees)."""
    dlist = np.array([np.sqrt(2), 1])
    opn = np.full(Z.shape, np.inf)
    for L in ladder:
        dist = cellsize * L * dlist[d % 2]
        ang = (np.pi / 2) - np.arctan((np_ashift(Z, d, int(L)) - Z) / dist)
        opn = np.minimum(opn, ang)
    return np.rad2deg(opn)


def np_progressive_window(lookup, how_fast=20):
    """The reference's percent-growth L ladder (neilpy.py:1314-1321,
    called as progressive_window(1, lookup_pixels, how_fast))."""
    out, last = [1], 1
    while last < lookup:
        last = int(np.ceil(last * (100 + how_fast) / 100))
        if last <= lookup:
            out.append(last)
    return out


def np_geomorphons(Z, cellsize=1, lookup_pixels=1, threshold_angle=1,
                   enhance=False, fast=False, how_fast=20,
                   return_margin=False):
    """f64 geomorphon oracle with the J&S table, the reference's
    'enhance' correction pass (neilpy.py:1640-1649), and the 'fast'
    progressive ladder.  ``return_margin=True`` also returns the
    per-pixel minimum |openness-difference - (+/-)threshold| across
    directions (and across both enhance scales): pixels at ~0 margin
    are the only ones whose class may flip under f32 arithmetic."""
    lut = np.zeros((9, 9), dtype=np.uint8)
    lut[0, :] = [1, 1, 1, 8, 8, 9, 9, 9, 10]
    lut[1, :8] = [1, 1, 8, 8, 8, 9, 9, 9]
    lut[2, :7] = [1, 4, 6, 6, 7, 7, 9]
    lut[3, :6] = [4, 4, 6, 6, 6, 7]
    lut[4, :5] = [4, 4, 5, 6, 6]
    lut[5, :4] = [3, 3, 5, 5]
    lut[6, :3] = [3, 3, 3]
    lut[7, :2] = [3, 3]
    lut[8, :1] = [2]
    npn, nng, margin = np_count_openness(
        Z, cellsize, lookup_pixels, threshold_angle, fast, how_fast,
        return_margin=True)
    G = lut[npn.ravel(), nng.ravel()].reshape(Z.shape)
    if enhance and lookup_pixels > 16:
        lk = max(int(np.floor(lookup_pixels / 4)), 4)
        ns, gs_n, margin_sm = np_count_openness(
            Z, cellsize, lk, threshold_angle, return_margin=True)
        Gs = lut[ns.ravel(), gs_n.ravel()].reshape(Z.shape)
        G = G.copy()
        G[(G == 4) & (Gs == 1)] = 1
        G[(G == 8) & (Gs == 1)] = 1
        G[(G == 2) | (G == 3)] = Gs[(G == 2) | (G == 3)]
        margin = np.minimum(margin, margin_sm)
    if return_margin:
        return G, margin
    return G


def np_gradient_slope(Z, cellsize=1, z_factor=1, return_as="degrees"):
    gy, gx = np.gradient(Z, cellsize / z_factor)
    S = np.sqrt(gx ** 2 + gy ** 2)
    if return_as in ("degrees", "radians"):
        S = np.arctan(S)
        if return_as == "degrees":
            S = np.rad2deg(S)
    return S


def np_hillshade(Z, cellsize=1, z_factor=1, zenith=45, azimuth=315):
    zen, azi = np.deg2rad((zenith, azimuth))
    S = np.arctan(np_gradient_slope(Z, cellsize, z_factor, "percent"))
    gy, gx = np.gradient(Z)
    A = np.pi / 2 - np.arctan2(gy, -gx)
    A[A < 0] += 2 * np.pi
    A[(gx == 0) & (gy == 0)] = 0
    H = np.cos(zen) * np.cos(S) + np.sin(zen) * np.sin(S) * np.cos(azi - A)
    H[H < 0] = 0
    return np.round(255 * H).astype(np.uint8)


def np_progressive_filter(Z, windows, cellsize=1, slope_threshold=.15):
    """SMRF progressive morphological filter oracle using scipy grey
    opening with the exact skimage-style disk footprint."""
    import scipy.ndimage as ndi
    from neilpy_tpu.core.codes import disk
    last = Z.copy()
    is_obj = np.zeros(Z.shape, dtype=bool)
    thresholds = slope_threshold * (np.asarray(windows) * cellsize)
    for i, w in enumerate(np.atleast_1d(windows)):
        opened = ndi.grey_erosion(last, footprint=disk(w))
        opened = ndi.grey_dilation(opened, footprint=disk(w))
        is_obj |= (last - opened) > thresholds[i]
        last = opened.copy()
    return is_obj


def np_spring_inpaint(A, exact=True):
    """D'Errico method-4 spring inpainting oracle.

    ``exact=True`` (default) solves the spring least-squares problem's
    normal equations with a DIRECT sparse factorisation — the unique
    equilibrium, converged by construction, which is what bit-match
    assertions compare against.  ``exact=False`` reproduces the
    reference's literal solver call (``lsqr`` at scipy defaults,
    neilpy.py:1264), which carries O(1e-3) truncation error on large
    NaN regions — solver noise, not a different equilibrium."""
    from scipy import sparse
    m, n = A.shape
    nanmat = np.isnan(A)
    nan_list = np.flatnonzero(nanmat)
    known_list = np.flatnonzero(~nanmat)
    r, c = np.unravel_index(nan_list, (m, n))
    offsets = np.array([[0, 1], [0, -1], [-1, 0], [1, 0]])
    nbrs = np.vstack([np.vstack((r + o[0], c + o[1])).T for o in offsets])
    springs = np.tile(nan_list, 4)
    good = (np.all(nbrs >= 0, 1)) & (nbrs[:, 0] < m) & (nbrs[:, 1] < n)
    nbr_flat = np.ravel_multi_index((nbrs[good, 0], nbrs[good, 1]), (m, n))
    springs = np.sort(np.vstack((springs[good], nbr_flat)).T, axis=1)
    springs = np.unique(springs, axis=0)
    ns = springs.shape[0]
    i = np.tile(np.arange(ns), 2)
    data = np.hstack((np.ones(ns), -np.ones(ns)))
    S = sparse.coo_matrix((data, (i, springs.T.ravel())),
                          (ns, m * n)).tocsr()
    Su = S[:, nan_list]
    rhs = -S[:, known_list] * A[np.unravel_index(known_list, (m, n))]
    if exact:
        res = sparse.linalg.spsolve((Su.T @ Su).tocsc(), Su.T @ rhs)
    else:
        res = sparse.linalg.lsqr(Su, rhs)[0]
    B = A.copy()
    B[np.unravel_index(nan_list, (m, n))] = res
    return B


def np_ladder_margin(Zi, windows, cellsize=1, slope_threshold=.15):
    """Per-cell minimum |(last - opened) - threshold| across the
    opening ladder: how close each cell's object decisions sit to the
    thresholds.  Cells at ~0 margin are f64-degenerate ties (ISPRS z
    has 2 decimals, thresholds are 2-decimal multiples) whose boolean
    depends on the inpaint solver's last rounding bit."""
    import scipy.ndimage as ndi
    from neilpy_tpu.core.codes import disk
    last = Zi.copy()
    margin = np.full(Zi.shape, np.inf)
    thresholds = slope_threshold * (np.asarray(windows) * cellsize)
    for i, w in enumerate(np.atleast_1d(windows)):
        opened = ndi.grey_erosion(last, footprint=disk(w))
        opened = ndi.grey_dilation(opened, footprint=disk(w))
        margin = np.minimum(margin,
                            np.abs((last - opened) - thresholds[i]))
        last = opened.copy()
    return margin


def np_smrf(x, y, z, cellsize, windows, slope_threshold,
            elevation_threshold, elevation_scaler, low_filter_slope=5,
            return_margin=False, return_point_margin=False):
    """Full f64 SMRF oracle composed from the scipy building blocks
    (pandas-style groupby binning, direct-solve spring inpaint, scipy
    disk opening ladder, FITPACK RectBivariateSpline point lift) — the
    reference pipeline's numerical behaviour end to end
    (neilpy.py:1685-1808).  Reproduces the published samp12 total
    error of 3.091% exactly.  ``return_margin=True`` additionally
    returns the per-cell ladder decision margin (see
    ``np_ladder_margin``); ``return_point_margin=True`` appends the
    per-point margin ``| |ev - z| - req |`` of the final elevation
    test."""
    from scipy.interpolate import RectBivariateSpline
    from neilpy_tpu.ops.pointgrid import bin_points

    windows = np.arange(windows) + 1 if np.isscalar(windows) else windows
    flat, valid, (ny, nx), t = bin_points(x, y, cellsize=cellsize)
    z64 = np.asarray(z, float)
    Zmin = np.full(ny * nx, np.inf)
    np.minimum.at(Zmin, flat[valid], z64[valid])
    Zmin[np.isinf(Zmin)] = np.nan
    Zmin = Zmin.reshape(ny, nx)
    empty = np.isnan(Zmin)
    Zmin = np_spring_inpaint(Zmin)
    low = np_progressive_filter(-Zmin, [1], cellsize, low_filter_slope)
    obj = np_progressive_filter(Zmin, windows, cellsize, slope_threshold)
    obj = obj | empty | low
    if return_margin:
        margin = np.minimum(
            np_ladder_margin(Zmin, windows, cellsize, slope_threshold),
            np_ladder_margin(-Zmin, [1], cellsize, low_filter_slope))
    Zpro = Zmin.copy()
    Zpro[obj] = np.nan
    Zpro = np_spring_inpaint(Zpro)
    c, r = (~t) * (np.asarray(x, float), np.asarray(y, float))
    ev = RectBivariateSpline(np.arange(ny) + .5, np.arange(nx) + .5,
                             Zpro).ev(r, c)
    gy, gx = np.gradient(Zpro, cellsize)
    sv = RectBivariateSpline(np.arange(ny) + .5, np.arange(nx) + .5,
                             np.sqrt(gy ** 2 + gx ** 2)).ev(r, c)
    req = elevation_threshold + elevation_scaler * sv
    out = (np.abs(ev - z64) > req, obj)
    if return_margin:
        out += (margin,)
    if return_point_margin:
        out += (np.abs(np.abs(ev - z64) - req),)
    return out


# ---- decision-margin audit of the lossy uint16 mosaic uplink --------
# (``upload_dtype='uint16'``: affine lattice over the global range,
# quantum q = (max-min)/65534).  A quantization perturbs every elevation
# by <= q/2, so a pos-neg openness difference moves by <=
# 2*rad2deg(q/cellsize); a class flip whose f64 margin exceeds that
# bound could not have been caused by quantization.

# direction offsets / step weights must match neilpy_tpu.core.shift
OFFSETS = None
STEP_LENGTH = None


def _load_conventions():
    global OFFSETS, STEP_LENGTH
    if OFFSETS is None:
        from neilpy_tpu.core.shift import OFFSETS as O, STEP_LENGTH as S
        OFFSETS, STEP_LENGTH = O, S


def pointwise_margins(Z, rows, cols, cellsize=1.0, lookup_pixels=1,
                      threshold_angle=1.0):
    """f64 geomorphon decision margins at selected pixels only.

    Returns ``margins`` (degrees), shape ``(len(rows),)``: the smallest
    |O_d ∓ threshold| over the 8 directions, where O_d is the
    single-direction positive-minus-negative openness difference of the
    reference ladder.  Out-of-range ladder steps contribute ratio 0
    (angle 90°), the reference's ashift edge-replication semantics.
    Vectorized over pixels, so a few thousand pixels at R=50 cost
    milliseconds where a full-raster f64 oracle would run for hours."""
    _load_conventions()
    Z = np.asarray(Z, dtype=np.float64)
    H, W = Z.shape
    r = np.asarray(rows, dtype=np.int64)
    c = np.asarray(cols, dtype=np.int64)
    Zp = Z[r, c]
    margin = np.full(r.shape, np.inf)
    t = float(threshold_angle)
    for d in range(8):
        dr, dc = OFFSETS[d]
        w = float(STEP_LENGTH[d])
        pos = np.full(r.shape, np.inf)
        neg = np.full(r.shape, np.inf)
        for L in range(1, int(lookup_pixels) + 1):
            rr = r + dr * L
            cc = c + dc * L
            valid = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
            val = Z[np.clip(rr, 0, H - 1), np.clip(cc, 0, W - 1)]
            ratio = np.where(valid, (val - Zp) / (cellsize * w * L), 0.0)
            ang_p = np.pi / 2 - np.arctan(ratio)
            ang_n = np.pi / 2 - np.arctan(-ratio)
            # NaN never replaces the running min (reference semantics)
            pos = np.where(np.isnan(ang_p), pos, np.minimum(pos, ang_p))
            neg = np.where(np.isnan(ang_n), neg, np.minimum(neg, ang_n))
        O = np.rad2deg(pos) - np.rad2deg(neg)
        margin = np.minimum(margin, np.minimum(np.abs(O - t),
                                               np.abs(O + t)))
    return margin


def margin_bound_deg(q, cellsize):
    """Max angular movement of a pos-neg openness difference under a
    per-sample elevation perturbation of one quantization quantum
    ``q``: 2 * rad2deg(q / cellsize) (atan is 1-Lipschitz; L=1, w=1 is
    the worst ladder step)."""
    return float(2.0 * np.rad2deg(q / cellsize))


def audit_flips(Z, G_exact, G_quant, qlo, qhi, cellsize,
                lookup_pixels, threshold_angle, interior=None,
                f32_allowance=0.01):
    """Audit every interior class flip between the exact-transport and
    quantized-transport geomorphon planes.  Returns a dict with the
    agreement rate, flip count, max f64 margin over flipped pixels,
    the quantization margin bound, and the pass verdict
    (max_margin <= bound + f32_allowance degrees)."""
    G_exact = np.asarray(G_exact)
    G_quant = np.asarray(G_quant)
    H, W = G_exact.shape
    flip = G_exact != G_quant
    R = int(lookup_pixels) if interior is None else int(interior)
    inner = np.zeros_like(flip)
    inner[R:H - R, R:W - R] = True
    rows, cols = np.nonzero(flip & inner)
    q = (float(qhi) - float(qlo)) / 65534.0
    bound = margin_bound_deg(q, cellsize)
    if len(rows):
        margins = pointwise_margins(Z, rows, cols, cellsize,
                                    lookup_pixels, threshold_angle)
        max_margin = float(np.max(margins))
    else:
        max_margin = 0.0
    return {
        "agreement": float(np.mean(G_exact == G_quant)),
        "n_flips_interior": int(len(rows)),
        "n_flips_total": int(flip.sum()),
        "quantum": q,
        "margin_bound_deg": bound,
        "f32_allowance_deg": f32_allowance,
        "max_flip_margin_deg": max_margin,
        "all_flips_within_bound": bool(max_margin
                                       <= bound + f32_allowance),
    }
