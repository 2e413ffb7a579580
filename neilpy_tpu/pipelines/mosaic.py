"""Out-of-core terrain analysis for continent-scale mosaics
(BASELINE config 5: sharded SMRF + geomorphons + Moran's-I
autocorrelation over a synthetic 100k x 100k DEM mosaic).

A 100k x 100k float32 mosaic is 40 GB — beyond single-chip HBM — so
this pipeline streams overlapping tiles through ONE fused device
program producing every requested product per pass (geomorphon
classes, local Moran's I, SMRF object cells), with tile-granular
checkpoint/resume (SURVEY.md §5: "tile-granular restart for the
100k x 100k mosaic config is the one real need").

Composing with the mesh (config-5's actual topology): pass ``mesh=``
and the tile stream is round-robined across the mesh devices — each
device runs the SAME fused tile program on its own tile under
``shard_map`` (tiles carry their own overlap halo, so no cross-device
collective is needed; upload/readback per device overlap through the
async dispatch queue).  Out-of-core streaming and multi-device
execution then compose: a 100k x 100k mosaic on a four-card host runs
4 tiles per dispatch with per-tile checkpoint keys.

The overlap is chosen for exactness, not vibes:

* geomorphons at lookup L need an L-px halo;
* a progressive opening ladder over windows w_1..w_k contaminates a
  band of 2 * sum(w_i) px at a tile edge (each opening widens the
  wrong band by erosion + dilation radii);
* local Moran's I with a radius-r footprint needs r + 1 px (its
  z-normalization is global and is computed in a first streaming
  pass over the raw tiles).

so ``overlap = max(lookup, 2*sum(windows), gi_radius + 1)`` (over the
*requested* products only) makes the tiled result equal the untiled
one everywhere except within ``overlap`` pixels of the *global* mosaic
boundary, where tile edge padding approximates each kernel's own
boundary convention (asserted in tests, same contract the reference
accepted from apply_parallel).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ..backend import mosaic_defaults
from ..dist.tiling import tiled_apply
from ..ops.visibility import geomorphons
from ..ops.stats import local_morans_i

__all__ = ["mosaic_terrain_products", "required_overlap"]


#: fixed product order on the wire and in the returned tuple
_PRODUCT_ORDER = ("geomorphons", "objects", "moran", "gi",
                  "openness_pos", "openness_neg")


def required_overlap(lookup_pixels=0, windows=(), gi_radius=0,
                     products=None):
    """Exactness halo for the fused tile kernel (see module docstring).
    With ``products`` given, only the halos of the requested products
    count — a geomorphons-only mosaic needs just the lookup halo."""
    if products is None:
        products = ("geomorphons", "objects", "moran")
    needs = set(products)
    lk = (int(lookup_pixels)
          if needs & {"geomorphons", "openness_pos", "openness_neg"}
          else 0)
    ladder = (int(2 * np.sum(windows))
              if "objects" in needs and np.size(windows) else 0)
    gi = int(gi_radius) + 1 if needs & {"moran", "gi"} and gi_radius \
        else 0
    return max(lk, ladder, gi)


def _normalize_products(products, gi_star, openness):
    if products is None:
        products = ["geomorphons", "objects", "moran"]
    else:
        products = list(products)
    if gi_star and "gi" not in products:
        products.append("gi")
    if openness:
        for p in ("openness_pos", "openness_neg"):
            if p not in products:
                products.append(p)
    unknown = set(products) - set(_PRODUCT_ORDER)
    if unknown:
        raise ValueError(f"unknown mosaic products {sorted(unknown)}; "
                         f"choose from {_PRODUCT_ORDER}")
    if not products:
        # catch this at the API boundary: an empty set would otherwise
        # surface as an unrelated concatenate error inside the kernel
        raise ValueError("products must name at least one of "
                         f"{_PRODUCT_ORDER}")
    if ("openness_pos" in products) != ("openness_neg" in products):
        # one ladder pass produces both; forcing the pair keeps the
        # wire layout unambiguous
        raise ValueError("openness_pos/openness_neg come as a pair")
    return tuple(p for p in _PRODUCT_ORDER if p in products)


def _input_fingerprint(Z):
    """Cheap identity check for the moments sidecar: shape + dtype +
    a hash of three sampled row strips (first / middle / last).  A
    full content hash of a 40 GB memmap would cost a whole extra pass;
    the sampled strips catch the realistic accident — reusing a
    checkpoint path with a different raster — at ~5 MB of reads."""
    import hashlib
    H = int(Z.shape[0])
    W = int(Z.shape[1])
    h = hashlib.sha256(repr((H, W, str(Z.dtype))).encode())
    k = min(4, H)
    for r0 in sorted({0, max(0, H // 2 - k // 2), H - k}):
        strip = np.ascontiguousarray(
            np.asarray(Z[r0:r0 + k, 0:W]))
        h.update(strip.tobytes())
    return h.hexdigest()[:16]


class _QuantizedSource:
    """Lazy uint16 affine-quantized view of a 2-D source: windows read
    through ``__getitem__`` encode on the host as
    ``round((v - lo) * 65534 / (hi - lo))`` with non-finite cells at
    the sentinel 65535 — HALF the upload bytes of an f32 source through
    the (bandwidth-bound) device link.  The fused tile body dequantizes
    on device with the matching f32 affine, so the whole pipeline
    behaves exactly as if it ran on the dequantized raster (asserted
    bit-exactly in tests); quantization error is bounded by
    ``(hi - lo) / 65534`` — centimeters for a typical terrain mosaic's
    global range."""

    def __init__(self, Z, lo, hi):
        self._Z = Z
        self.lo = float(lo)
        self.hi = float(hi)
        self.enc = 65534.0 / (self.hi - self.lo) if self.hi > self.lo \
            else 1.0
        # the f32 decode constants the device body must use (f32 so the
        # "== mosaic of the dequantized raster" equivalence is exact)
        self.dec_scale = np.float32((self.hi - self.lo) / 65534.0
                                    if self.hi > self.lo else 0.0)
        self.dec_off = np.float32(self.lo)
        self.shape = Z.shape
        self.dtype = np.dtype(np.uint16)
        self.ndim = 2
        self.size = int(np.prod(Z.shape))
        self.nbytes = 2 * self.size

    def __getitem__(self, idx):
        # f32 in-place encode: the f64 pipeline measured 2.6 s/tile of
        # host time on the one-vCPU box — slower than the upload it
        # saved.  f32 rounding perturbs the pre-rint value by <= ~0.007
        # of a quantization step (65534 * 1e-7), well inside the
        # documented (hi-lo)/65534 error bound, and the encode stays a
        # single deterministic function of the source everywhere it is
        # evaluated (run, resume, verify).
        v = np.asarray(self._Z[idx], dtype=np.float32)
        q = v - np.float32(self.lo)
        q *= np.float32(self.enc)
        np.rint(q, out=q)
        np.clip(q, 0.0, 65534.0, out=q)
        q[~np.isfinite(v)] = 65535.0
        return q.astype(np.uint16)

    def dequantized(self):
        """Host f32 raster the quantized transport is equivalent to
        (materializes — test/verification helper)."""
        q = self[:, :]
        v = q.astype(np.float32) * self.dec_scale + self.dec_off
        return np.where(q == 65535, np.float32(np.nan), v)


#: uint8 Moran wire: z clipped to ±_MORAN8_RANGE, 254 steps, 255 = NaN
_MORAN8_RANGE = 8.0


def _make_product_body(cellsize, lookup_pixels, threshold_angle, win,
                       gi_radius, use_pallas, fast, how_fast, compact,
                       tile_size, overlap, products, quantize=False,
                       float_wire="bf16", bitpack=False):
    """Pure fused tile program: ``(block, thresholds, mean, s2, n) ->
    packed (tile_size, n_bytes) uint8`` — every requested product,
    overlap crop, and byte-packing in one traceable body, shared by the
    single-chip wire kernel and the per-shard mesh kernel.

    ``compact`` selects the wire encoding: geomorphon class and object
    bit share one uint8 when both are requested (class 1-10 needs 7
    bits; bit 7 carries the object flag — lossless) and float products
    travel as bfloat16 (~3 significant digits; the only lossy leg).
    That is 3 B/px on the wire instead of 6 for the default product
    set — the device->host link is the mosaic bottleneck, not the
    kernel."""
    from ..ops.morphology import _disk_morph
    from ..dist.tiling import _pack_device

    eng = "pallas" if use_pallas else "xla"
    geo = lambda b: geomorphons(b, cellsize=cellsize,
                                lookup_pixels=lookup_pixels,
                                threshold_angle=threshold_angle,
                                fast=fast, how_fast=how_fast, engine=eng)

    ts, ov = tile_size, overlap
    combine = compact and ("geomorphons" in products
                           and "objects" in products)

    def body(block, thresholds, mean, s2, n, qscale, qoff):
        # product semantics are f32 regardless of the source raster's
        # dtype; the coercion happens ON DEVICE so the transport
        # (dist.tiling) can ship the source's native dtype
        if quantize:
            # uint16 affine wire (see _QuantizedSource): dequantize on
            # device; 65535 is the non-finite sentinel
            q = block.astype(jnp.float32)
            block = jnp.where(block == jnp.uint16(65535), jnp.nan,
                              q * qscale + qoff)
        else:
            block = jnp.asarray(block, jnp.float32)
        vals = {}
        if "geomorphons" in products:
            vals["geomorphons"] = geo(block)
        if "objects" in products:
            last = block
            objects = jnp.zeros(block.shape, dtype=bool)
            for i, w in enumerate(win):
                opened = _disk_morph(_disk_morph(last, w, jnp.minimum),
                                     w, jnp.maximum)
                objects = objects | ((last - opened) > thresholds[i])
                last = opened
            vals["objects"] = objects
        if "moran" in products:
            vals["moran"] = local_morans_i(block, footprint=gi_radius,
                                           mean=mean, s2=s2)
        if "gi" in products:
            from ..ops.stats import rasterGi
            _, _, gi = rasterGi(block, footprint=gi_radius, star=True,
                                global_mean=mean, global_var=s2,
                                global_n=n)
            vals["gi"] = gi
        if "openness_pos" in products:
            # one ladder pass yields BOTH planes (openness_pair); on
            # the Pallas engine the 8-direction reduction happens
            # in-kernel — 2 plane writes instead of 16
            from ..ops.visibility import openness_pair
            vals["openness_pos"], vals["openness_neg"] = openness_pair(
                block, cellsize=cellsize, lookup_pixels=lookup_pixels,
                fast=fast, how_fast=how_fast, engine=eng)

        res = []
        for p in products:
            a = vals[p]
            if combine and p == "geomorphons":
                a = (a.astype(jnp.uint8)
                     | (vals["objects"].astype(jnp.uint8) << 7))
            elif combine and p == "objects":
                continue  # riding bit 7 of the geomorphon byte
            elif compact and p == "gi":
                # the ±3 significance bins encode LOSSLESSLY in one
                # byte (bin+3 in 0..6, 255 = NaN) — half the bf16 wire
                a = jnp.where(jnp.isnan(a), jnp.float32(255.0),
                              a + 3.0).astype(jnp.uint8)
            elif compact and p == "moran" and float_wire == "uint8":
                # opt-in lossy z-bins: clip to ±_MORAN8_RANGE, 254
                # uniform steps (quantum 16/254 ≈ 0.063 z, half-step
                # error ≤ 0.032), 255 = NaN.  |z| > 8 is astronomically
                # significant either way; the bins keep hot/cold-spot
                # maps intact at 1 B/px
                r = jnp.float32(_MORAN8_RANGE)
                enc = jnp.rint((jnp.clip(a, -r, r) + r)
                               * (254.0 / (2.0 * r)))
                a = jnp.where(jnp.isnan(a), jnp.float32(255.0),
                              enc).astype(jnp.uint8)
            elif compact and p in ("moran", "openness_pos",
                                   "openness_neg"):
                # moran/openness round to ~3 significant digits
                a = a.astype(jnp.bfloat16)
            elif p == "geomorphons":
                a = a.astype(jnp.uint8)
            a = a[ov:ov + ts, ov:ov + ts]
            if bitpack and p == "objects" and not combine:
                # 1-bit plane: 8 object flags per byte (MSB-first so
                # the host expands with np.unpackbits) — 8x less
                # downlink than the bool byte plane
                bits = a.astype(jnp.uint32).reshape(ts, ts // 8, 8)
                pw = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1],
                                 dtype=jnp.uint32)
                a = jnp.sum(bits * pw, axis=2).astype(jnp.uint8)
            res.append(a)
        packed, _ = _pack_device(res)
        return packed

    return body


@lru_cache(maxsize=16)
def _make_tile_kernel(cellsize, lookup_pixels, threshold_angle, win,
                      gi_radius, use_pallas, fast, how_fast, compact,
                      tile_size, overlap, n_chunks, products,
                      quantize=False, float_wire="bf16",
                      bitpack=False):
    """Build (and cache) the fused jitted single-chip tile WIRE kernel:
    the product body plus readback chunking inside one program, so a
    tile costs ONE dispatch.

    Caching by static parameters keeps the compiled program alive
    across ``mosaic_terrain_products`` calls — a fresh closure per call
    would recompile the program inside every mosaic run.  The global Moran moments and the ladder
    thresholds are traced arguments for the same reason.
    """
    body = _make_product_body(cellsize, lookup_pixels, threshold_angle,
                              win, gi_radius, use_pallas, fast,
                              how_fast, compact, tile_size, overlap,
                              products, quantize, float_wire, bitpack)
    ts = tile_size

    @jax.jit
    def tile_kernel(block, thresholds, mean, s2, n, qscale, qoff):
        packed = body(block, thresholds, mean, s2, n, qscale, qoff)
        step = -(-ts // n_chunks)
        return tuple(packed[i:i + step] for i in range(0, ts, step))

    # Persistent-executable cache (neilpy_tpu.aot): off unless
    # NEILPY_AOT_CACHE is set, in which case a resumed mosaic or a
    # fresh process loads the compiled tile program from disk.
    from ..aot import CachedKernel
    return CachedKernel(tile_kernel, key=(
        "mosaic_tile", cellsize, lookup_pixels, threshold_angle, win,
        gi_radius, use_pallas, fast, how_fast, compact, tile_size,
        overlap, n_chunks, products, quantize, float_wire, bitpack))


@lru_cache(maxsize=16)
def _make_mesh_tile_kernel(mesh1, cellsize, lookup_pixels,
                           threshold_angle, win, gi_radius, use_pallas,
                           fast, how_fast, compact, tile_size, overlap,
                           products, quantize=False, float_wire="bf16",
                           bitpack=False):
    """Per-GROUP mesh kernel: ``(D, B, B) blocks -> (D, ts, n_bytes)``
    wire buffers, one tile per device under ``shard_map`` over the flat
    ``tile`` axis.  Tiles are independent (each carries its own overlap
    halo), so the program contains no collective — D fused tile
    programs run concurrently, one per chip, and the sharded output's
    per-device shards are read back independently."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    body = _make_product_body(cellsize, lookup_pixels, threshold_angle,
                              win, gi_radius, use_pallas, fast,
                              how_fast, compact, tile_size, overlap,
                              products, quantize, float_wire, bitpack)

    def local(blocks, thresholds, mean, s2, n, qscale, qoff):
        return body(blocks[0], thresholds, mean, s2, n, qscale,
                    qoff)[None]

    axis = tuple(mesh1.shape.keys())[0]
    # check_vma=False: the pallas_call output inside the shard does not
    # carry mesh-axis vma types (same workaround dist.api uses)
    return jax.jit(shard_map(
        local, mesh=mesh1,
        in_specs=(P(axis), P(), P(), P(), P(), P(), P()),
        out_specs=P(axis), check_vma=False))


def _wire_specs(compact, products, float_wire="bf16", bitpack=False):
    combine = compact and ("geomorphons" in products
                           and "objects" in products)
    specs = []
    for p in products:
        if p == "geomorphons":
            specs.append((np.dtype(np.uint8), 1))
        elif p == "objects":
            if combine:
                continue
            specs.append((np.dtype(np.uint8), 0.125) if bitpack
                         else (np.dtype(bool), 1))
        elif compact and (p == "gi" or (p == "moran"
                                        and float_wire == "uint8")):
            specs.append((np.dtype(np.uint8), 1))
        elif compact:
            specs.append((np.dtype(jnp.bfloat16), 2))
        else:
            specs.append((np.dtype(np.float32), 4))
    return specs


def _make_decode(compact, products, float_wire="bf16", bitpack=False):
    """Host decode: wire products -> caller products (fixed order)."""
    combine = compact and ("geomorphons" in products
                           and "objects" in products)

    def decode(res):
        out = []
        i = 0
        for p in products:
            if combine and p == "geomorphons":
                combo = res[i]
                out.append(combo & 0x7F)
                i += 1
            elif combine and p == "objects":
                out.append(res[i - 1] >= 128)
            elif bitpack and p == "objects":
                out.append(np.unpackbits(res[i], axis=1).astype(bool))
                i += 1
            elif compact and p == "gi":
                v = res[i]
                out.append(np.where(v == 255, np.float32(np.nan),
                                    v.astype(np.float32) - 3.0))
                i += 1
            elif compact and p == "moran" and float_wire == "uint8":
                v = res[i]
                r = np.float32(_MORAN8_RANGE)
                dec = v.astype(np.float32) * (2 * r / 254) - r
                out.append(np.where(v == 255, np.float32(np.nan), dec))
                i += 1
            elif compact and p in ("moran", "openness_pos",
                                   "openness_neg"):
                out.append(np.asarray(res[i]).astype(np.float32))
                i += 1
            else:
                out.append(res[i])
                i += 1
        return tuple(out)

    return decode if (compact or combine) else None


_OUT_DTYPE = {"geomorphons": np.uint8, "objects": bool,
              "moran": np.float32, "gi": np.float32,
              "openness_pos": np.float32, "openness_neg": np.float32}


def mosaic_terrain_products(Z, cellsize=1, lookup_pixels=25,
                            threshold_angle=1, windows=5,
                            slope_threshold=.15, gi_radius=3,
                            tile_size=2048, checkpoint=None,
                            out=None, progress=False, use_pallas=None,
                            fast=False, how_fast=20, wire="auto",
                            pipeline_depth=3, wire_chunks=None,
                            gi_star=False, openness=False,
                            products=None, mesh=None,
                            device_input="auto", phase_stats=None,
                            prefetch=None, upload_dtype=None,
                            float_wire=None):
    """Stream a (possibly memory-mapped) mosaic through one fused tile
    kernel computing the requested products; resumable at tile
    granularity via ``checkpoint``.

    ``products`` selects what the tile kernel computes (and pays for):
    any subset of ``("geomorphons", "objects", "moran", "gi",
    "openness_pos", "openness_neg")``, returned in that fixed order;
    default ``("geomorphons", "objects", "moran")`` — the classic
    config-5 trio.  ``gi_star=True`` / ``openness=True`` append their
    products (kept for API continuity).  The Gi* product is the
    ArcGIS-style significance bins (float32 in {0, ±1, ±2, ±3}, NaN
    over NaN cells) with the same ``gi_radius`` square neighbourhood,
    z-scored against the GLOBAL mosaic moments; openness is the
    positive/negative Yokoyama pair on the same ``lookup_pixels``
    ladder.  The first streaming pass for the global Moran/Gi moments
    only runs when ``moran``/``gi`` are requested.  ``out`` may be a
    tuple of matching preallocated (memory-mapped) arrays for mosaics
    whose products do not fit in RAM.

    ``mesh`` composes the out-of-core stream with multi-chip execution:
    tiles are round-robined over ``mesh``'s devices (any mesh shape —
    it is flattened to one ``tile`` axis) and each device runs the same
    fused tile program on its own tile per dispatch.  Results,
    checkpoint granularity, and resume semantics are identical to the
    single-device path (asserted in tests on a virtual 8-device mesh).

    ``wire`` controls the device->host encoding of each tile:
    ``'exact'`` sends uint8 + bool + float32 products; ``'compact'``
    halves or better the wire per plane (class+object share a byte; a
    standalone objects plane bit-packs to 1 bit/px; Gi significance
    bins ship as one byte LOSSLESSLY; other float products as bfloat16
    — classes, object cells and Gi bins stay EXACT, moran/openness
    round to ~3 significant digits).  ``'auto'`` resolves to exact
    (``backend.mosaic_defaults``).

    ``float_wire='uint8'`` (opt-in, LOSSY, compact wire only) ships the
    local-Moran plane as 254 uniform z-bins over ±8 (quantum ≈ 0.063 z,
    half-step error ≤ 0.032; NaN preserved) — 1 B/px instead of bf16's
    2.  Hot/cold-spot structure survives exactly; use when the Moran
    plane's downlink share matters more than its third significant
    digit.  Default ``'bf16'``.

    ``device_input`` forwards to ``dist.tiling.tiled_apply``: ``'auto'``
    uploads inputs under the device budget once and slices tile windows
    on device; ``False`` forces the true out-of-core streaming path
    (what a 50k/100k disk mosaic uses regardless).  ``phase_stats``:
    pass ``{}`` to collect the tile loop's cumulative per-phase wall
    times (see ``tiled_apply``; works on both paths).  With ``mesh=``
    the tile stream uses the mesh group loop, whose acquisition and
    transfer structure is fixed — ``prefetch``, ``device_input`` and
    ``wire_chunks`` apply only to the single-device streaming path and
    are ignored there.

    ``upload_dtype='uint16'`` (opt-in, LOSSY) quantizes the host->device
    leg — the dominant wire cost for float sources (4 B/px up vs 1-3
    down) — to an affine uint16 encoding against the global raster
    range: error <= (max - min) / 65534 (centimeters for a typical
    terrain mosaic), non-finite cells preserved via a sentinel code.
    The pipeline then behaves as if run on the dequantized raster, up
    to one rounding difference: the on-device dequantization compiles
    to a fused multiply-add (one rounding) where a host dequantization
    rounds twice, so ppm-level decision-tie pixels may classify
    differently (measured 45/9M on a synthetic check; asserted in
    tests).  moran/gi additionally z-normalize against moments of the
    ORIGINAL raster, which is marginally more accurate than
    dequantized-raster moments.  Ignored for sources already <= 2 B/px
    (int16/uint8 transports are lossless as-is); the default ``None``
    keeps the f32-exact transport.
    """
    products = _normalize_products(products, gi_star, openness)
    if np.isscalar(windows):
        windows = np.arange(windows) + 1
    windows = np.atleast_1d(np.asarray(windows))
    ov = required_overlap(lookup_pixels, windows, gi_radius, products)

    # Global Moran/Gi z-normalization: one cheap streaming pass for the
    # global mean/variance (the tile kernel must not normalize locally
    # or tiled != untiled).  Lazy 2-D sources (io.geotiff.GeoTiffSource,
    # np.memmap) pass through un-materialized: both this pass and
    # tiled_apply read them window-by-window.  Skipped entirely when no
    # requested product needs the moments.
    if not (hasattr(Z, "shape") and hasattr(Z, "dtype")
            and hasattr(Z, "__getitem__")):
        Z = np.asarray(Z)
    if upload_dtype not in (None, "uint16"):
        raise ValueError("upload_dtype must be None or 'uint16'")
    # validate BEFORE the (possibly whole-raster) moments pass below —
    # a typo'd wire option must not cost a 40 GB streaming read first
    if float_wire is None:
        float_wire = "bf16"
    if float_wire not in ("bf16", "uint8"):
        raise ValueError("float_wire must be 'bf16' or 'uint8'")
    quantize = (upload_dtype == "uint16"
                and np.dtype(Z.dtype).itemsize > 2)
    mean = s2 = 0.0
    n_finite = 0
    qlo = qhi = 0.0
    need_moments = bool({"moran", "gi"} & set(products))
    if need_moments or quantize:
        # the moments (and, for the quantized transport, the global
        # min/max) are a full pass over the (possibly huge, on-disk)
        # input — cache them next to the tile checkpoint so a resumed
        # run doesn't re-read the whole mosaic before its first tile
        import json as _json
        import os as _os
        mom_path = (str(checkpoint) + ".moments") if checkpoint else None
        # the sidecar is only trusted for the SAME input: a reused
        # checkpoint path with a different raster (the library's own
        # "delete the checkpoint file to recompute" advice leaves the
        # sidecar behind) must recompute, not z-normalize against the
        # previous mosaic's moments
        input_fp = _input_fingerprint(Z) if mom_path else None
        mom = None
        if mom_path and _os.path.exists(mom_path):
            cand = _json.load(open(mom_path))
            if cand.get("input_fp") == input_fp and (
                    not quantize or "qlo" in cand):
                mom = cand
        if mom is not None:
            mean, s2, n_finite = (mom["mean"], mom["s2"],
                                  int(mom["n_finite"]))
            qlo = float(mom.get("qlo", 0.0))
            qhi = float(mom.get("qhi", 0.0))
        else:
            gsum = 0.0
            gsq = 0.0
            gmin = np.inf
            gmax = -np.inf
            for r0 in range(0, Z.shape[0], 4096):
                # f64 ACCUMULATORS over the f32 blocks (sum(dtype=) /
                # einsum(dtype=)) rather than f64 block copies: same
                # result to ~2e-15 relative, ~60x faster on the host
                # (the copy+mask path measured 17 s per 256 MB block —
                # longer than the tile stream it was the prologue to)
                blk = np.asarray(Z[r0:r0 + 4096], dtype=np.float32)
                m = np.isfinite(blk)
                if not m.all():
                    blk = np.where(m, blk, np.float32(0.0))
                    if m.any():
                        gmin = min(gmin, float(blk[m].min()))
                        gmax = max(gmax, float(blk[m].max()))
                else:
                    gmin = min(gmin, float(blk.min()))
                    gmax = max(gmax, float(blk.max()))
                gsum += float(blk.sum(dtype=np.float64))
                gsq += float(np.einsum("ij,ij->", blk, blk,
                                       dtype=np.float64))
                n_finite += int(m.sum())
            mean = gsum / max(n_finite, 1)
            s2 = gsq / max(n_finite, 1) - mean * mean
            qlo = gmin if np.isfinite(gmin) else 0.0
            qhi = gmax if np.isfinite(gmax) else 0.0
            if mom_path:
                tmp = mom_path + ".tmp"
                _json.dump({"mean": mean, "s2": s2,
                            "n_finite": n_finite,
                            "qlo": qlo, "qhi": qhi,
                            "input_fp": input_fp}, open(tmp, "w"))
                _os.replace(tmp, mom_path)

    thresholds = jnp.asarray(slope_threshold * (windows * cellsize),
                             dtype=jnp.float32)
    win = tuple(int(w) for w in windows) if "objects" in products \
        else ()

    if quantize:
        Z = _QuantizedSource(Z, qlo, qhi)
        qscale = jnp.float32(Z.dec_scale)
        qoff = jnp.float32(Z.dec_off)
    else:
        qscale = jnp.float32(0.0)
        qoff = jnp.float32(0.0)

    # Both ladder engines treat tile edges with the same edge-replication
    # convention, so the overlap crop keeps tiled == untiled either way.
    use_pallas, wire, prefetch = mosaic_defaults(use_pallas, wire,
                                                 prefetch)
    compact = wire == "compact"
    # a standalone objects plane (no geomorphon byte to ride) bit-packs
    # on the compact wire whenever the tile width splits into bytes
    bitpack = (compact and "objects" in products
               and "geomorphons" not in products
               and int(tile_size) % 8 == 0)
    specs = _wire_specs(compact, products, float_wire, bitpack)
    px_bytes = sum(nb for _, nb in specs)
    decode = _make_decode(compact, products, float_wire, bitpack)
    out_dtype = tuple(_OUT_DTYPE[p] for p in products)

    if mesh is not None:
        from jax.sharding import Mesh
        devs = mesh.devices.reshape(-1)
        mesh1 = Mesh(devs, ("tile",))
        kernel = _make_mesh_tile_kernel(
            mesh1, float(cellsize), int(lookup_pixels),
            float(threshold_angle), win, int(gi_radius),
            bool(use_pallas), bool(fast), int(how_fast), compact,
            int(tile_size), int(ov), products, quantize, float_wire,
            bitpack)
        mesh_fn = lambda blocks: kernel(blocks, thresholds,
                                        jnp.float32(mean),
                                        jnp.float32(s2),
                                        jnp.float32(n_finite),
                                        qscale, qoff)
        # prefetch / device_input / wire_chunks are streaming-path
        # knobs; the mesh group loop has its own acquisition and
        # transfer structure, so they do not apply here
        res = tiled_apply(None, Z, tile_size=tile_size, overlap=ov,
                          out=out, out_dtype=out_dtype,
                          checkpoint=checkpoint, progress=progress,
                          pipeline_depth=pipeline_depth,
                          wire_specs=specs, decode=decode,
                          mesh=mesh1, mesh_wire_fn=mesh_fn,
                          phase_stats=phase_stats)
        return res

    # chunk the wire buffer into ~12 MB pieces so several async host
    # copies are in flight at once
    n_chunks = (int(wire_chunks) if wire_chunks
                else max(1, min(16, round(tile_size ** 2 * px_bytes
                                          / (12 << 20)))))
    kernel = _make_tile_kernel(
        float(cellsize), int(lookup_pixels), float(threshold_angle),
        win, int(gi_radius), bool(use_pallas), bool(fast),
        int(how_fast), compact, int(tile_size), int(ov), n_chunks,
        products, quantize, float_wire, bitpack)
    wire_fn = lambda b: kernel(b, thresholds, jnp.float32(mean),
                               jnp.float32(s2), jnp.float32(n_finite),
                               qscale, qoff)

    return tiled_apply(None, Z, tile_size=tile_size, overlap=ov,
                       out=out, out_dtype=out_dtype,
                       checkpoint=checkpoint, progress=progress,
                       pipeline_depth=pipeline_depth, wire_fn=wire_fn,
                       wire_specs=specs, decode=decode,
                       device_input=device_input,
                       phase_stats=phase_stats, prefetch=prefetch)
