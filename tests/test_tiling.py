import numpy as np
import pytest

from neilpy_tpu.dist.tiling import tiled_apply, TileCheckpoint
from neilpy_tpu.ops.surface import hillshade
from neilpy_tpu.ops.visibility import geomorphons


@pytest.mark.heavy
def test_tiled_hillshade_matches_interior(rng):
    Z = rng.normal(size=(100, 130)).cumsum(axis=0).astype(np.float32)
    full = np.asarray(hillshade(Z, cellsize=2))
    tiled = tiled_apply(lambda b: hillshade(b, cellsize=2), Z,
                        tile_size=40, overlap=4)
    # interior matches exactly; the global border differs because tile
    # edge-padding approximates np.gradient's one-sided edge stencil
    assert (tiled[4:-4, 4:-4] == full[4:-4, 4:-4]).all()


@pytest.mark.heavy
def test_tiled_geomorphons(rng):
    Z = rng.normal(size=(90, 110)).cumsum(axis=0).cumsum(axis=1)
    Z = Z.astype(np.float32)
    lookup = 5
    full = np.asarray(geomorphons(Z, lookup_pixels=lookup))
    tiled = tiled_apply(lambda b: geomorphons(b, lookup_pixels=lookup),
                        Z, tile_size=40, overlap=lookup)
    k = lookup
    assert (tiled[k:-k, k:-k] == full[k:-k, k:-k]).all()


def test_checkpoint_resume(tmp_path, rng):
    Z = rng.normal(size=(60, 60)).astype(np.float32)
    ck = str(tmp_path / "tiles.json")
    calls = []

    def fn(b):
        calls.append(1)
        return b * 2

    out1 = tiled_apply(fn, Z, tile_size=20, overlap=2, checkpoint=ck)
    n_first = len(calls)
    assert n_first == 9
    # resume: nothing left to do
    out2 = tiled_apply(fn, Z, tile_size=20, overlap=2, checkpoint=ck,
                       out=out1)
    assert len(calls) == n_first
    np.testing.assert_array_equal(out1, Z * 2)


def test_partial_resume(tmp_path, rng):
    Z = rng.normal(size=(40, 40)).astype(np.float32)
    ck = str(tmp_path / "t.json")
    c = TileCheckpoint(ck)
    c.mark((0, 0))
    out = np.zeros_like(Z)
    tiled_apply(lambda b: b + 1, Z, tile_size=20, overlap=0, out=out,
                checkpoint=ck)
    # tile (0,0) skipped (stays zero), others computed
    assert (out[:20, :20] == 0).all()
    assert (out[20:, 20:] == Z[20:, 20:] + 1).all()


@pytest.mark.heavy
def test_mosaic_terrain_products(tmp_path):
    """Fused multi-product mosaic pipeline: tiled == untiled in the
    interior for all three products, resumable at tile granularity."""
    import jax.numpy as jnp
    from neilpy_tpu.pipelines.mosaic import (mosaic_terrain_products,
                                             required_overlap)
    from neilpy_tpu.pipelines.smrf import progressive_filter
    from neilpy_tpu.ops.stats import local_morans_i

    rng = np.random.default_rng(42)
    Z = rng.normal(size=(100, 120)).cumsum(axis=0).cumsum(axis=1)
    Z = (Z / 10).astype(np.float32)
    lookup, windows, gi_r = 4, np.array([1, 2, 3]), 2
    ov = required_overlap(lookup, windows, gi_r)
    assert ov == 2 * (1 + 2 + 3)

    ck = str(tmp_path / "mosaic.json")
    G, O, MI = mosaic_terrain_products(
        Z, cellsize=1, lookup_pixels=lookup, windows=windows,
        gi_radius=gi_r, tile_size=48, checkpoint=ck)

    full_G = np.asarray(geomorphons(Z, cellsize=1, lookup_pixels=lookup,
                                    threshold_angle=1))
    full_O = np.asarray(progressive_filter(Z, windows, 1, .15))
    full_MI = np.asarray(local_morans_i(jnp.asarray(Z), footprint=gi_r))

    s = np.s_[ov:-ov, ov:-ov]
    assert (G[s] == full_G[s]).all()
    assert (O[s] == full_O[s]).all()
    # f32 convolution reassociation between the tiled and untiled
    # schedules: values are O(10-100), allow proportional slack
    np.testing.assert_allclose(MI[s], full_MI[s], rtol=1e-4, atol=1e-3)

    # resume: all tiles done -> no recompute, outputs intact; the
    # global Moran moments are cached in a checkpoint sidecar so the
    # resume does not re-read the whole input
    import os
    assert os.path.exists(ck + ".moments")
    out = (G.copy(), O.copy(), MI.copy())
    G2, O2, MI2 = mosaic_terrain_products(
        Z, cellsize=1, lookup_pixels=lookup, windows=windows,
        gi_radius=gi_r, tile_size=48, checkpoint=ck, out=out)
    assert (G2 == G).all() and (O2 == O).all()
    np.testing.assert_array_equal(MI2, MI)


@pytest.mark.heavy
def test_mosaic_pallas_tile_kernel_matches(rng):
    """The Pallas tile kernel (interpret mode on CPU) and the XLA tile
    kernel classify identically through the mosaic pipeline."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(64, 80)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=32)
    G1, O1, M1 = mosaic_terrain_products(Z, use_pallas=False, **kw)
    G2, O2, M2 = mosaic_terrain_products(Z, use_pallas=True, **kw)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(O1, O2)
    np.testing.assert_allclose(M1, M2, atol=1e-5)


@pytest.mark.heavy
def test_mosaic_compact_wire(rng):
    """Compact wire encoding (class+object packed into one byte,
    Moran's I as bfloat16): classes and object cells stay EXACT; Moran
    values round to bf16 precision."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(96, 96)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=2, tile_size=48)
    G1, O1, M1 = mosaic_terrain_products(Z, wire="exact", **kw)
    G2, O2, M2 = mosaic_terrain_products(Z, wire="compact", **kw)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(O1, O2)
    assert G2.dtype == np.uint8 and O2.dtype == bool
    assert M2.dtype == np.float32
    np.testing.assert_allclose(M1, M2, rtol=1e-2, atol=1e-2)


def test_mosaic_objects_bitpacked_wire(rng):
    """A standalone objects plane (no geomorphon byte to ride its bit
    7) ships BIT-PACKED on the compact wire — 1 bit/px, 8x less
    downlink than the bool byte plane (VERDICT r4 #4): decoded mask
    identical to the exact wire, including cropped edge tiles."""
    from neilpy_tpu.pipelines.mosaic import (mosaic_terrain_products,
                                             _wire_specs)
    Z = rng.normal(size=(100, 88)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1, windows=np.array([1, 2]), tile_size=48,
              products=("objects",))
    (O1,) = mosaic_terrain_products(Z, wire="exact", **kw)
    (O2,) = mosaic_terrain_products(Z, wire="compact", **kw)
    np.testing.assert_array_equal(O1, O2)
    assert O1.dtype == bool and O2.dtype == bool
    specs = _wire_specs(True, ("objects",), bitpack=True)
    assert specs == [(np.dtype(np.uint8), 0.125)]


def test_mosaic_moran_uint8_wire(rng):
    """float_wire='uint8' (opt-in) ships the Moran plane as 254
    z-bins over ±8: values within the half-step quantum of the exact
    wire, NaN pattern preserved, classes/objects untouched
    (VERDICT r4 #4)."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(96, 96)).cumsum(axis=0).astype(np.float32)
    Z[30:33, 40:44] = np.nan
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=2, tile_size=48)
    G1, O1, M1 = mosaic_terrain_products(Z, wire="exact", **kw)
    G2, O2, M2 = mosaic_terrain_products(Z, wire="compact",
                                         float_wire="uint8", **kw)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(O1, O2)
    np.testing.assert_array_equal(np.isnan(M1), np.isnan(M2))
    fin = np.isfinite(M1)
    # clip region: exact values beyond ±8 decode to the clip bound
    clipped = np.clip(M1[fin], -8.0, 8.0)
    assert np.max(np.abs(clipped - M2[fin])) <= 16 / 254 / 2 + 1e-6
    with pytest.raises(ValueError):
        mosaic_terrain_products(Z, float_wire="float16", **kw)


@pytest.mark.heavy
def test_mosaic_gi_star_product(rng):
    """gi_star=True appends the Gi* significance bins as a fourth
    product, z-scored against the GLOBAL mosaic moments: tiled ==
    single-shot rasterGi given the same moments, in the interior, on
    both wire encodings (bins are small ints — exact even in bf16)."""
    from neilpy_tpu.pipelines.mosaic import (mosaic_terrain_products,
                                             required_overlap)
    from neilpy_tpu.ops.stats import rasterGi
    Z = rng.normal(size=(100, 110)).cumsum(axis=1).astype(np.float32)
    Z[40:43, 50:55] = np.nan
    gi_r = 2
    ov = required_overlap(4, np.array([1, 2]), gi_r)
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=gi_r, tile_size=48, gi_star=True)
    G1, O1, M1, S1 = mosaic_terrain_products(Z, wire="exact", **kw)
    G2, O2, M2, S2 = mosaic_terrain_products(Z, wire="compact", **kw)
    assert S1.dtype == np.float32 and S2.dtype == np.float32

    # single-shot oracle with the identical f64-streamed moments
    m = np.isfinite(Z)
    mean = Z[m].astype(np.float64).sum() / m.sum()
    s2 = (Z[m].astype(np.float64) ** 2).sum() / m.sum() - mean ** 2
    _, _, full = rasterGi(Z, footprint=gi_r, star=True,
                          global_mean=mean, global_var=s2,
                          global_n=m.sum())
    full = np.asarray(full)
    sl = np.s_[ov:-ov, ov:-ov]
    for S in (S1, S2):
        nan_ok = np.isnan(S[sl]) == np.isnan(full[sl])
        assert nan_ok.all()
        fin = ~np.isnan(full[sl])
        # identical inputs modulo f32 reassociation: allow rare
        # razor-edge bin flips only
        assert np.mean(S[sl][fin] == full[sl][fin]) > 0.999
    assert set(np.unique(S1[np.isfinite(S1)])) <= {-3., -2., -1., 0.,
                                                   1., 2., 3.}


@pytest.mark.heavy
def test_mosaic_openness_products(rng):
    """openness=True appends positive and negative Yokoyama openness:
    tiled == untiled in the interior (the lookup overlap already
    covers the scan ladder), composable with gi_star."""
    from neilpy_tpu.pipelines.mosaic import (mosaic_terrain_products,
                                             required_overlap)
    from neilpy_tpu.ops.visibility import openness
    Z = rng.normal(size=(100, 110)).cumsum(axis=0).astype(np.float32)
    lookup = 4
    ov = required_overlap(lookup, np.array([1, 2]), 2)
    res = mosaic_terrain_products(
        Z, cellsize=1, lookup_pixels=lookup, windows=np.array([1, 2]),
        gi_radius=2, tile_size=48, wire="exact", gi_star=True,
        openness=True)
    assert len(res) == 6
    G, O, MI, S, OP, ON = res
    full_p = np.asarray(openness(Z, cellsize=1, lookup_pixels=lookup))
    full_n = np.asarray(openness(-Z, cellsize=1, lookup_pixels=lookup))
    sl = np.s_[ov:-ov, ov:-ov]
    np.testing.assert_allclose(OP[sl], full_p[sl], atol=1e-5)
    np.testing.assert_allclose(ON[sl], full_n[sl], atol=1e-5)
    # compact wire: same products at bf16 resolution
    res2 = mosaic_terrain_products(
        Z, cellsize=1, lookup_pixels=lookup, windows=np.array([1, 2]),
        gi_radius=2, tile_size=48, wire="compact", gi_star=True,
        openness=True)
    np.testing.assert_array_equal(res2[0], G)
    np.testing.assert_allclose(res2[4][sl], full_p[sl], rtol=1e-2,
                               atol=0.5)


def test_completed_checkpoint_without_out_raises(tmp_path):
    from neilpy_tpu.dist.tiling import tiled_apply
    Z = np.ones((20, 20), dtype=np.float32)
    ck = str(tmp_path / "c.json")
    tiled_apply(lambda b: b, Z, tile_size=20, overlap=0, checkpoint=ck)
    with pytest.raises(ValueError, match="every tile done"):
        tiled_apply(lambda b: b, Z, tile_size=20, overlap=0,
                    checkpoint=ck)


@pytest.mark.heavy
def test_apply_parallel_reference_signature():
    """skimage.util.apply_parallel drop-in (the reference notebooks
    call it directly): interior pixels (> depth from the global edge)
    must equal the untiled result; only the depth-wide border band may
    feel the padded boundary, exactly like skimage."""
    import jax
    import numpy as np
    import neilpy_tpu as nt
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(120, 150)).cumsum(axis=0).astype(np.float32)
    fn = lambda b: np.asarray(nt.geomorphons(b, cellsize=2,
                                             lookup_pixels=5))
    full = fn(Z)
    tiled = nt.apply_parallel(fn, Z, 64, 5)
    d = tiled != full
    band = np.zeros_like(d)
    band[:5, :] = band[-5:, :] = True
    band[:, :5] = band[:, -5:] = True
    assert not (d & ~band).any(), "interior must be exact"
    # chunks=None runs the whole array through fn
    np.testing.assert_array_equal(nt.apply_parallel(fn, Z), full)
    # extra_arguments/extra_keywords pass through
    fn2 = lambda b, cs, lookup_pixels=1: np.asarray(
        nt.geomorphons(b, cellsize=cs, lookup_pixels=lookup_pixels))
    t2 = nt.apply_parallel(fn2, Z, 64, 5, extra_arguments=(2,),
                           extra_keywords={"lookup_pixels": 5})
    np.testing.assert_array_equal(t2, tiled)


def test_mosaic_from_geotiff_source(tmp_path, rng):
    """Out-of-core from DISK: mosaic_terrain_products consumes a lazy
    GeoTiffSource window-by-window (never materializing the raster)
    and produces exactly what the in-RAM array produces."""
    from neilpy_tpu.io.geotiff import write_geotiff, GeoTiffSource
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(96, 80)).cumsum(axis=0).astype(np.float32)
    fn = str(tmp_path / "dem.tif")
    write_geotiff(fn, Z, compress="deflate")
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48)
    G1, O1, M1 = mosaic_terrain_products(Z, **kw)
    src = GeoTiffSource(fn)
    G2, O2, M2 = mosaic_terrain_products(src, **kw)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(O1, O2)
    np.testing.assert_allclose(M1, M2, atol=1e-6)


def test_mosaic_products_opt_in(rng):
    """``products=`` computes (and pays for) only what was asked:
    a geomorphons-only mosaic needs just the lookup halo, skips the
    global-moments pass, and returns a 1-tuple equal to the full run's
    geomorphon product."""
    from neilpy_tpu.pipelines.mosaic import (mosaic_terrain_products,
                                             required_overlap)
    Z = rng.normal(size=(90, 100)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=2, tile_size=48)
    G, O, MI = mosaic_terrain_products(Z, **kw)
    (G2,) = mosaic_terrain_products(Z, products=("geomorphons",), **kw)
    np.testing.assert_array_equal(G, G2)
    (O2,) = mosaic_terrain_products(Z, products=("objects",), **kw)
    np.testing.assert_array_equal(O, O2)
    M3, = mosaic_terrain_products(Z, products=("moran",), **kw)
    np.testing.assert_allclose(MI, M3, atol=1e-6)
    # overlap scales down with the requested set
    assert required_overlap(4, np.array([1, 2]), 2,
                            ("geomorphons",)) == 4
    assert required_overlap(4, np.array([1, 2]), 2, ("moran",)) == 3
    assert required_overlap(4, np.array([1, 2]), 2,
                            ("objects",)) == 6
    with pytest.raises(ValueError, match="unknown"):
        mosaic_terrain_products(Z, products=("nope",), **kw)
    with pytest.raises(ValueError, match="pair"):
        mosaic_terrain_products(Z, products=("openness_pos",), **kw)


def test_pointwise_margins_match_full_raster_oracle(rng):
    """The audit's pointwise f64 margin kernel (reference_impls)
    must agree BIT-EXACTLY with the independent full-raster oracle's
    margin plane (reference_impls.np_count_openness return_margin) at
    every pixel, including raster edges — the certification's margin
    numbers are only as trustworthy as this equivalence."""
    from tests.reference_impls import np_count_openness, pointwise_margins
    Z = rng.normal(size=(40, 50)).cumsum(axis=0)
    _, _, marg = np_count_openness(Z, cellsize=2, lookup_pixels=6,
                                   threshold_angle=1,
                                   return_margin=True)
    rows, cols = np.mgrid[0:40, 0:50]
    pm = pointwise_margins(Z, rows.ravel(), cols.ravel(), cellsize=2,
                           lookup_pixels=6,
                           threshold_angle=1).reshape(40, 50)
    np.testing.assert_array_equal(pm, marg)


def test_mosaic_quantized_flip_margin_audit(rng):
    """Every geomorphon class flip between the exact-f32 and the
    uint16-quantized transports must sit inside the quantization's own
    decision window: its f64 margin to the ±threshold_angle boundary
    (reference ladder semantics) below the analytic bound
    2·rad2deg(quantum/cellsize) (the 'confined to decision
    boundaries' claim, asserted; same tie-pixel methodology as the
    Pallas-vs-XLA comparison)."""
    from tests.reference_impls import audit_flips
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    # gentle terrain + large global range: ratios cluster near the
    # threshold so the tiny uint16 quantum actually flips some pixels
    Z = (rng.normal(size=(256, 256)).cumsum(axis=0)
         + rng.normal(size=(256, 256)).cumsum(axis=1)).astype(np.float32)
    Z *= np.float32(8.0)
    kw = dict(cellsize=64, lookup_pixels=8, tile_size=128,
              products=("geomorphons",), wire="exact")
    (G1,) = mosaic_terrain_products(Z, **kw)
    (G2,) = mosaic_terrain_products(Z, upload_dtype="uint16", **kw)
    rep = audit_flips(Z, G1, G2, qlo=np.nanmin(Z), qhi=np.nanmax(Z),
                      cellsize=64, lookup_pixels=8, threshold_angle=1)
    assert rep["agreement"] > 0.99
    assert rep["all_flips_within_bound"], rep


def test_mosaic_quantized_upload(rng):
    """``upload_dtype='uint16'`` (the lossy half-byte transport): the
    quantized mosaic must equal — BIT-exactly — the normal mosaic run
    on the dequantized raster (the documented semantic), the
    dequantization error must respect the (hi-lo)/65534 bound, and NaN
    holes must survive the sentinel round-trip."""
    from neilpy_tpu.pipelines.mosaic import (mosaic_terrain_products,
                                             _QuantizedSource)
    Z = rng.normal(size=(90, 100)).cumsum(axis=0).astype(np.float32)
    Z[40:44, 50:60] = np.nan
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=2, tile_size=48)
    Gq, Oq, Mq = mosaic_terrain_products(Z, upload_dtype="uint16", **kw)

    fin = Z[np.isfinite(Z)]
    src = _QuantizedSource(Z, fin.min(), fin.max())
    Zdq = src.dequantized()
    # error bound + hole preservation
    assert np.array_equal(np.isnan(Zdq), np.isnan(Z))
    # ideal half-step plus ~1% of f32 encode/decode rounding — still
    # 2x tighter than the documented (hi-lo)/65534 bound
    bound = (float(fin.max()) - float(fin.min())) / 65534 * 0.505
    assert np.nanmax(np.abs(Zdq - Z)) <= bound + 1e-6
    # equivalence with running on the dequantized raster: exact up to
    # fused-multiply-add rounding of the on-device dequantization
    # (ppm-level decision-tie flips); moran matches to quantization
    # precision (its global z-moments come from the ORIGINAL raster —
    # the quantized run normalizes slightly more accurately, not less)
    G2, O2, M2 = mosaic_terrain_products(Zdq, **kw)
    assert np.mean(Gq == G2) >= 0.9999
    assert np.mean(Oq == O2) >= 0.9999
    np.testing.assert_allclose(Mq, M2, atol=1e-3, rtol=1e-3)


def test_mosaic_quantized_noop_for_narrow_dtypes(rng):
    """uint16 upload quantization is a no-op for sources already at
    <= 2 B/px: an int16 mosaic gives identical results either way."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = (rng.normal(size=(70, 80)).cumsum(axis=0) * 50).astype(np.int16)
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48)
    a = mosaic_terrain_products(Z, **kw)
    b = mosaic_terrain_products(Z, upload_dtype="uint16", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        mosaic_terrain_products(Z, upload_dtype="int8", **kw)


class TestMosaicMesh:
    """Config-5 topology: out-of-core tile streaming COMPOSED with
    multi-chip execution — tiles round-robined over the (virtual
    8-device) mesh, one fused tile program per device per dispatch
    (VERDICT r3 #1).  Results must be identical to the single-device
    stream, checkpoint/resume included."""

    @pytest.fixture(scope="class")
    def mesh(self):
        from neilpy_tpu.dist.api import make_mesh
        return make_mesh()

    def test_mesh_matches_single(self, mesh, rng):
        from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
        Z = rng.normal(size=(200, 260)).cumsum(axis=0).astype(np.float32)
        Z[60:63, 70:74] = np.nan  # nodata hole crosses a tile
        kw = dict(cellsize=2, lookup_pixels=6, windows=np.array([1, 2]),
                  gi_radius=2, tile_size=48)
        G1, O1, M1 = mosaic_terrain_products(Z, **kw)
        G2, O2, M2 = mosaic_terrain_products(Z, mesh=mesh, **kw)
        np.testing.assert_array_equal(G1, G2)
        np.testing.assert_array_equal(O1, O2)
        np.testing.assert_array_equal(np.nan_to_num(M1, nan=9e9),
                                      np.nan_to_num(M2, nan=9e9))
        # quantized upload on the mesh path == quantized single-device
        Gq1, Oq1, _ = mosaic_terrain_products(Z, upload_dtype="uint16",
                                              **kw)
        Gq2, Oq2, _ = mosaic_terrain_products(Z, mesh=mesh,
                                              upload_dtype="uint16",
                                              **kw)
        np.testing.assert_array_equal(Gq1, Gq2)
        np.testing.assert_array_equal(Oq1, Oq2)

    def test_mesh_compact_wire_and_subset(self, mesh, rng):
        from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
        Z = rng.normal(size=(150, 170)).cumsum(axis=1).astype(np.float32)
        kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1]),
                  gi_radius=1, tile_size=48)
        G1, O1, M1 = mosaic_terrain_products(Z, **kw)
        G2, O2, M2 = mosaic_terrain_products(Z, mesh=mesh,
                                             wire="compact", **kw)
        np.testing.assert_array_equal(G1, G2)  # classes exact on wire
        np.testing.assert_array_equal(O1, O2)
        np.testing.assert_allclose(M1, M2, rtol=1e-2, atol=1e-2)
        (G3,) = mosaic_terrain_products(Z, mesh=mesh,
                                        products=("geomorphons",), **kw)
        np.testing.assert_array_equal(G1, G3)

    def test_mesh_phase_stats_populated(self, mesh, rng):
        """phase_stats works on the MESH path too (r4 advisory: the
        mesh branch used to drop the kwarg silently)."""
        from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
        Z = rng.normal(size=(96, 96)).cumsum(axis=1).astype(np.float32)
        ps = {}
        mosaic_terrain_products(Z, mesh=mesh, phase_stats=ps,
                                cellsize=1, lookup_pixels=4,
                                windows=np.array([1]), gi_radius=1,
                                tile_size=48)
        for key in ("host_read", "upload", "dispatch",
                    "readback_wait", "tiles", "total"):
            assert key in ps, key
        assert ps["tiles"] == 4
        assert ps["total"] > 0

    def test_mesh_checkpoint_resume(self, mesh, tmp_path, rng):
        """Per-TILE checkpoint keys survive the grouped mesh dispatch:
        pre-marking an arbitrary subset (as a mid-group kill would
        leave) resumes only the missing tiles, on any group boundary."""
        from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
        Z = rng.normal(size=(190, 230)).cumsum(axis=0).astype(np.float32)
        kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
                  gi_radius=1, tile_size=48)
        G0, O0, M0 = mosaic_terrain_products(Z, **kw)

        ck = str(tmp_path / "mesh_mosaic.json")
        full = mosaic_terrain_products(Z, mesh=mesh, checkpoint=ck, **kw)
        # simulate a kill that completed 5 arbitrary tiles: keep their
        # outputs, drop the rest, resume over the mesh
        c = TileCheckpoint(str(tmp_path / "partial.json"))
        done = [(0, 0), (1, 2), (2, 4), (3, 1), (0, 3)]
        for k in done:
            c.mark(k)
        outs = tuple(np.zeros_like(a) for a in full)
        for (ty, tx) in done:
            for o, f in zip(outs, full):
                o[ty * 48:(ty + 1) * 48, tx * 48:(tx + 1) * 48] = \
                    f[ty * 48:(ty + 1) * 48, tx * 48:(tx + 1) * 48]
        res = mosaic_terrain_products(
            Z, mesh=mesh, checkpoint=str(tmp_path / "partial.json"),
            out=outs, **kw)
        for r, f in zip(res, (G0, O0, M0)):
            np.testing.assert_array_equal(np.nan_to_num(r, nan=9e9),
                                          np.nan_to_num(f, nan=9e9))

    def test_mesh_from_lazy_source(self, mesh, tmp_path, rng):
        """Out-of-core AND multi-chip at once: a lazy GeoTiffSource
        streams window-by-window into the mesh-grouped dispatch."""
        from neilpy_tpu.io.geotiff import write_geotiff, GeoTiffSource
        from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
        Z = rng.normal(size=(140, 120)).cumsum(axis=0).astype(np.float32)
        fn = str(tmp_path / "dem.tif")
        write_geotiff(fn, Z, compress="deflate")
        kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
                  gi_radius=1, tile_size=48)
        G1, O1, M1 = mosaic_terrain_products(Z, **kw)
        G2, O2, M2 = mosaic_terrain_products(GeoTiffSource(fn),
                                             mesh=mesh, **kw)
        np.testing.assert_array_equal(G1, G2)
        np.testing.assert_array_equal(O1, O2)
        np.testing.assert_allclose(M1, M2, atol=1e-6)


def test_mosaic_streaming_equals_resident(rng):
    """The forced out-of-core path (device_input=False, banded per-tile
    uploads through _banded_put) must produce exactly what the device-
    resident path does — the 50k/100k disk runs ride on this."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(100, 130)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=2, tile_size=48)
    G1, O1, M1 = mosaic_terrain_products(Z, device_input=True, **kw)
    G2, O2, M2 = mosaic_terrain_products(Z, device_input=False, **kw)
    np.testing.assert_array_equal(G1, G2)
    np.testing.assert_array_equal(O1, O2)
    np.testing.assert_allclose(M1, M2, atol=1e-5)


def test_prefetch_thread_equals_inline(rng):
    """The prefetch-thread acquisition path (upload/readback overlap) must be
    a pure scheduling change: identical outputs, identical phase keys,
    and the checkpoint/resume contract preserved."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(100, 130)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
              gi_radius=2, tile_size=48)
    outs = {}
    for pf in (False, True):
        ps = {}
        outs[pf] = mosaic_terrain_products(Z, prefetch=pf,
                                           phase_stats=ps, **kw)
        assert ps["tiles"] == 9
        assert ps["total"] > 0
        assert "dispatch" in ps and "readback_wait" in ps
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefetch_checkpoint_resume(tmp_path, rng):
    """Kill-and-resume semantics are unchanged under prefetch: a
    partially-checkpointed run completes only the missing tiles."""
    from neilpy_tpu.dist.tiling import tiled_apply, TileCheckpoint
    import jax
    Z = rng.normal(size=(70, 90)).astype(np.float32)
    f = jax.jit(lambda a: a * 3 + 2)
    want = np.asarray(f(Z))
    ck = str(tmp_path / "tiles.json")
    out = np.zeros_like(want)
    # seed a partial checkpoint: tile (0, 0) marked done, with its
    # output already stored (as a killed run would have left it)
    out[:32, :32] = want[:32, :32]
    TileCheckpoint(ck).mark((0, 0))
    got = tiled_apply(f, Z, tile_size=32, overlap=4, out=out,
                      checkpoint=ck, prefetch=True)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_prefetch_producer_error_propagates(rng):
    """An exception while acquiring a block on the prefetch thread
    surfaces on the caller, not as a hang."""
    from neilpy_tpu.dist.tiling import tiled_apply
    import jax

    class Boom:
        shape = (64, 64)
        dtype = np.dtype(np.float32)
        nbytes = 64 * 64 * 4

        def __getitem__(self, idx):
            raise RuntimeError("source read failed")

    f = jax.jit(lambda a: a + 1)
    with pytest.raises(RuntimeError, match="source read failed"):
        tiled_apply(f, Boom(), tile_size=32, overlap=4,
                    device_input=False, prefetch=True)


def test_tiled_apply_lazy_source_streaming(tmp_path, rng):
    """tiled_apply's true streaming path (device_input=False) slices
    windows straight off a lazy source."""
    from neilpy_tpu.io.geotiff import write_geotiff, GeoTiffSource
    from neilpy_tpu.dist.tiling import tiled_apply
    import jax
    Z = rng.normal(size=(70, 90)).astype(np.float32)
    fn = str(tmp_path / "z.tif")
    write_geotiff(fn, Z)
    f = jax.jit(lambda a: a * 2 + 1)
    want = np.asarray(f(Z))
    got = tiled_apply(f, GeoTiffSource(fn), tile_size=32, overlap=4,
                      device_input=False)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_tiled_apply_preserves_input_dtype():
    """apply_parallel drop-in semantics: fn must see tiles in the
    SOURCE dtype on both acquisition paths — coercion is the kernel's
    decision, not the transport's (r4 advisory: an f32 cast here
    silently truncated f64 DEMs and retyped uint8 class rasters)."""
    from neilpy_tpu.dist.tiling import tiled_apply
    rng = np.random.default_rng(7)
    seen = {}

    def fn(a):
        seen["dtype"] = np.asarray(a).dtype
        return a

    for dt in (np.uint8, np.float64):
        Z = (rng.random((70, 90)) * 100).astype(dt)
        # host streaming path and 'auto' must both preserve dtype
        # ('auto' routes non-canonical dtypes — f64 with x64 off — to
        # the host path; explicit device_input=True opts in to JAX
        # canonicalization instead)
        for dev in (False, "auto"):
            seen.clear()
            got = tiled_apply(fn, Z, tile_size=32, overlap=4,
                              device_input=dev)
            assert seen["dtype"] == np.dtype(dt), (dt, dev)
            assert got.dtype == np.dtype(dt), (dt, dev)
            np.testing.assert_array_equal(got, Z)


def test_moments_sidecar_ignores_different_input(tmp_path, rng):
    """The global-moments sidecar (<checkpoint>.moments) must be tied
    to the INPUT, not just the checkpoint path: following the library's
    own "delete the checkpoint file to recompute" advice and rerunning
    on a different raster used to z-normalize Moran/Gi against the
    previous raster's moments silently."""
    import os
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48)
    A = rng.normal(size=(96, 96)).cumsum(axis=0).astype(np.float32)
    B = (rng.normal(size=(96, 96)).cumsum(axis=1) * 50 + 1000.0) \
        .astype(np.float32)
    ck = str(tmp_path / "mosaic.json")
    mosaic_terrain_products(A, checkpoint=ck, **kw)
    assert os.path.exists(ck + ".moments")
    os.remove(ck)  # the documented way to force a recompute
    _, _, M_resumed = mosaic_terrain_products(B, checkpoint=ck, **kw)
    _, _, M_clean = mosaic_terrain_products(B, **kw)
    np.testing.assert_array_equal(np.nan_to_num(M_resumed, nan=9e9),
                                  np.nan_to_num(M_clean, nan=9e9))
    # and the SAME input still hits the sidecar (no moments recompute):
    # corrupt the stored moments and assert they are actually used
    import json
    mom = json.load(open(ck + ".moments"))
    ck2 = str(tmp_path / "mosaic2.json")
    mosaic_terrain_products(B, checkpoint=ck2, **kw)
    mom2 = json.load(open(ck2 + ".moments"))
    assert mom["input_fp"] == mom2["input_fp"]
    assert mom["mean"] == mom2["mean"]


def test_mosaic_empty_products_rejected(rng):
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    Z = rng.normal(size=(64, 64)).astype(np.float32)
    with pytest.raises(ValueError, match="at least one"):
        mosaic_terrain_products(Z, products=())


def test_device_resident_multiband_stripes(monkeypatch, tmp_path, rng):
    """The device-resident input path assembles PER-TILE-ROW stripes
    from small upload bands (so early tile rows compute while later
    bands are still uploading).  Shrink the band size so a small
    raster spans many bands, and check stripe stitching + edge
    replication against the host streaming path — including a
    checkpoint resume that rebuilds stripes from a partial work
    list."""
    from neilpy_tpu.dist import tiling
    from neilpy_tpu.dist.tiling import tiled_apply, TileCheckpoint
    import jax
    import jax.numpy as jnp
    # 3 rows per band: stripes straddle many band boundaries, and the
    # overlap crosses into neighbouring bands
    monkeypatch.setattr(tiling, "_BAND_BYTES", 3 * 90 * 4)
    Z = rng.normal(size=(70, 90)).astype(np.float32).cumsum(axis=0)

    def sten(b):
        b = jnp.asarray(b)
        return b + jnp.roll(b, 1, 0) + jnp.roll(b, -1, 1)

    want = tiled_apply(sten, Z, tile_size=32, overlap=4,
                       device_input=False)
    got = tiled_apply(sten, Z, tile_size=32, overlap=4,
                      device_input=True)
    np.testing.assert_array_equal(got, want)

    # resume: tiles (0,0) and (1,1) already done -> the remaining work
    # list skips within rows; stripes rebuild correctly
    ck = str(tmp_path / "tiles.json")
    out = np.zeros_like(want)
    out[:32, :32] = want[:32, :32]
    out[32:64, 32:64] = want[32:64, 32:64]
    c = TileCheckpoint(ck)
    c.mark((0, 0))
    c.mark((1, 1))
    got2 = tiled_apply(sten, Z, tile_size=32, overlap=4, out=out,
                       checkpoint=ck, device_input=True)
    np.testing.assert_array_equal(got2, want)
