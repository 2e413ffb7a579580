"""Pallas ladder kernel parity vs the XLA engine (interpret mode on the
CPU backend; the same kernel compiles through Triton on the GPU, and
its Triton lowering is checked here without a card)."""

import numpy as np
import pytest

from neilpy_tpu.ops.pallas_scan import (openness_counts_pallas,
                                        geomorphons_pallas)
from neilpy_tpu.ops.visibility import count_openness, geomorphons


@pytest.fixture(scope="module")
def Z(rng=None):
    r = np.random.default_rng(7)
    return r.normal(size=(100, 140)).cumsum(axis=0).cumsum(axis=1).astype(
        np.float32)


@pytest.mark.parametrize("threshold", [0.0, 1.0, 5.0])
def test_counts_match_xla(Z, threshold):
    np_p, nn_p = openness_counts_pallas(Z, cellsize=2.0, lookup_pixels=7,
                                        threshold_angle=threshold,
                                        block=(64, 64))
    np_x, nn_x = count_openness(Z, 2.0, 7, threshold)
    np.testing.assert_array_equal(np.asarray(np_p), np.asarray(np_x))
    np.testing.assert_array_equal(np.asarray(nn_p), np.asarray(nn_x))


@pytest.mark.parametrize("lookup", [1, 5, 13])
def test_classes_match_xla(Z, lookup):
    G_p = np.asarray(geomorphons_pallas(Z, cellsize=2.0,
                                        lookup_pixels=lookup,
                                        block=(64, 64)))
    G_x = np.asarray(geomorphons(Z, cellsize=2.0, lookup_pixels=lookup))
    np.testing.assert_array_equal(G_p, G_x)


def test_nan_terrain(Z):
    Zn = Z.copy()
    Zn[30:40, 50:70] = np.nan
    G_p = np.asarray(geomorphons_pallas(Zn, lookup_pixels=5,
                                        block=(64, 64)))
    G_x = np.asarray(geomorphons(Zn, lookup_pixels=5))
    np.testing.assert_array_equal(G_p, G_x)


@pytest.mark.parametrize("lookup", [7, 23])
def test_fast_ladder_matches_xla(Z, lookup):
    """'fast' progressive ladder (unrolled static slices in Pallas)
    visits the same L levels as the XLA scan -> identical classes."""
    G_p = np.asarray(geomorphons_pallas(Z, cellsize=2.0,
                                        lookup_pixels=lookup, fast=True,
                                        block=(64, 64)))
    G_x = np.asarray(geomorphons(Z, cellsize=2.0, lookup_pixels=lookup,
                                 fast=True, engine="xla"))
    np.testing.assert_array_equal(G_p, G_x)


@pytest.mark.heavy
def test_fast_ladder_nan_and_boundary():
    rng = np.random.default_rng(9)
    Z = rng.normal(size=(640, 640)).cumsum(axis=0).astype(np.float32)
    Z[200:210, 300:320] = np.nan
    G_p = np.asarray(geomorphons_pallas(Z, cellsize=2, lookup_pixels=23,
                                        fast=True, block=(64, 128)))
    G_x = np.asarray(geomorphons(Z, cellsize=2, lookup_pixels=23,
                                 fast=True, engine="xla"))
    np.testing.assert_array_equal(G_p, G_x)


def test_nan_hole_in_safe_tile():
    """A nodata hole deep in the raster interior, far from every edge:
    the compare-select ladder must skip the hole's NaN reads or every
    pixel whose ray crosses it is misclassified."""
    rng = np.random.default_rng(5)
    Z = rng.normal(size=(640, 640)).cumsum(axis=0).astype(np.float32)
    Z[200:210, 300:320] = np.nan
    G_p = np.asarray(geomorphons_pallas(Z, cellsize=2, lookup_pixels=2,
                                        block=(64, 128)))
    G_x = np.asarray(geomorphons(Z, cellsize=2, lookup_pixels=2,
                                 engine="xla"))
    np.testing.assert_array_equal(G_p, G_x)


def test_non_tile_aligned_shape():
    r = np.random.default_rng(3)
    Z = r.normal(size=(70, 90)).cumsum(axis=0).astype(np.float32)
    G_p = np.asarray(geomorphons_pallas(Z, lookup_pixels=4,
                                        block=(64, 64)))
    G_x = np.asarray(geomorphons(Z, lookup_pixels=4))
    np.testing.assert_array_equal(G_p, G_x)


@pytest.mark.heavy
def test_lookup_larger_than_tile(Z):
    # halo (R=40) far exceeds the 32-px tile: windows span many tiles
    G_p = np.asarray(geomorphons_pallas(Z[:64, :96], lookup_pixels=40,
                                        block=(32, 32)))
    G_x = np.asarray(geomorphons(Z[:64, :96], lookup_pixels=40))
    np.testing.assert_array_equal(G_p, G_x)


@pytest.mark.heavy
def test_geomorphons_engine_param(rng):
    from neilpy_tpu.ops.visibility import geomorphons
    Z = rng.normal(size=(40, 60)).cumsum(axis=0).astype(np.float32)
    a = np.asarray(geomorphons(Z, cellsize=2, lookup_pixels=5,
                               threshold_angle=1, engine="xla"))
    b = np.asarray(geomorphons(Z, cellsize=2, lookup_pixels=5,
                               threshold_angle=1, engine="pallas"))
    np.testing.assert_array_equal(a, b)
    # enhance path through the pallas engine
    Zb = rng.normal(size=(64, 64)).cumsum(axis=1).astype(np.float32)
    a = np.asarray(geomorphons(Zb, cellsize=1, lookup_pixels=18,
                               enhance=True, engine="xla"))
    b = np.asarray(geomorphons(Zb, cellsize=1, lookup_pixels=18,
                               enhance=True, engine="pallas"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.heavy
def test_openness_engine_param(rng):
    from neilpy_tpu.ops.visibility import openness
    Z = rng.normal(size=(48, 70)).cumsum(axis=0).astype(np.float32)
    Z[10:13, 20:25] = np.nan  # NaN terrain handled identically
    a = np.asarray(openness(Z, cellsize=2, lookup_pixels=6, engine="xla"))
    b = np.asarray(openness(Z, cellsize=2, lookup_pixels=6,
                            engine="pallas"))
    np.testing.assert_allclose(a, b, atol=1e-4, equal_nan=True)
    # direction subset
    a = np.asarray(openness(Z, lookup_pixels=4, neighbors=[1, 5],
                            engine="xla"))
    b = np.asarray(openness(Z, lookup_pixels=4, neighbors=[1, 5],
                            engine="pallas"))
    np.testing.assert_allclose(a, b, atol=1e-4, equal_nan=True)


def test_directional_extrema_pallas_matches_xla(rng):
    """Same division, same skips: the extrema are bit-identical."""
    from neilpy_tpu.ops.pallas_scan import directional_extrema_pallas
    from neilpy_tpu.ops.visibility import directional_ratio_extrema
    Z = rng.normal(size=(40, 60)).cumsum(axis=1).astype(np.float32)
    mx_p, mn_p = directional_extrema_pallas(Z, cellsize=1.5,
                                            lookup_pixels=7)
    mx_x, mn_x, seen = directional_ratio_extrema(Z, cellsize=1.5,
                                                 lookup_pixels=7)
    np.testing.assert_array_equal(np.asarray(mx_p), np.asarray(mx_x))
    np.testing.assert_array_equal(np.asarray(mn_p), np.asarray(mn_x))
    np.testing.assert_array_equal(np.asarray(mx_p) > -np.inf,
                                  np.asarray(seen))


def test_ternary_pattern_engine(rng):
    from neilpy_tpu.ops.visibility import ternary_pattern_from_openness
    Z = rng.normal(size=(40, 50)).cumsum(axis=0).astype(np.float32)
    a = np.asarray(ternary_pattern_from_openness(Z, lookup_pixels=5,
                                                 engine="xla"))
    b = np.asarray(ternary_pattern_from_openness(Z, lookup_pixels=5,
                                                 engine="pallas"))
    np.testing.assert_array_equal(a, b)


class TestFusedReduction:
    """The fused in-kernel reductions: openness / skyview / ternary
    reduce the 8 directional extrema inside the kernel (2/1/1 plane
    writes instead of 16)."""

    def test_openness_pair_engines(self, rng):
        """openness_pair: one ladder pass, both planes, both engines;
        the XLA pair is bit-identical to the two-pass openness(Z) /
        openness(-Z); the Pallas pair is within the in-kernel atan
        tolerance."""
        from neilpy_tpu.ops.visibility import openness, openness_pair
        Z = rng.normal(size=(90, 110)).cumsum(axis=0).astype(np.float32)
        Z[20:24, 30:36] = np.nan
        p2 = np.asarray(openness(Z, cellsize=2, lookup_pixels=8,
                                 engine="xla"))
        n2 = np.asarray(openness(-Z, cellsize=2, lookup_pixels=8,
                                 engine="xla"))
        p1, n1 = openness_pair(Z, cellsize=2, lookup_pixels=8,
                               engine="xla")
        np.testing.assert_array_equal(np.asarray(p1), p2)
        np.testing.assert_array_equal(np.asarray(n1), n2)
        pp, nn = openness_pair(Z, cellsize=2, lookup_pixels=8,
                               engine="pallas")
        np.testing.assert_allclose(np.asarray(pp), p2, atol=1e-4,
                                   equal_nan=True)
        np.testing.assert_allclose(np.asarray(nn), n2, atol=1e-4,
                                   equal_nan=True)

    def test_openness_unseen_is_inf(self):
        """A pixel whose every ladder step hits NaN must stay +inf in
        the fused kernel exactly like _angles_from_extrema."""
        from neilpy_tpu.ops.pallas_scan import openness_pallas
        Z = np.full((32, 140), np.nan, dtype=np.float32)
        Z[16, 70] = 5.0  # isolated pixel: all 8 rays see only NaN
        p, n = openness_pallas(Z, lookup_pixels=3)
        assert np.isposinf(np.asarray(p)[16, 70])
        assert np.isposinf(np.asarray(n)[16, 70])

    def test_skyview_engines(self, rng):
        from neilpy_tpu.ops.visibility import skyview_factor
        Z = rng.normal(size=(80, 100)).cumsum(axis=1).astype(np.float32)
        a = np.asarray(skyview_factor(Z, cellsize=1.5, lookup_pixels=9,
                                      engine="xla"))
        b = np.asarray(skyview_factor(Z, cellsize=1.5, lookup_pixels=9,
                                      engine="pallas"))
        np.testing.assert_allclose(a, b, atol=1e-6)

    @pytest.mark.heavy
    def test_ternary_modes_and_thresholds(self, rng):
        from neilpy_tpu.ops.visibility import ternary_pattern_from_openness
        Z = rng.normal(size=(70, 90)).cumsum(axis=0).astype(np.float32)
        Z[10:12, 20:23] = np.nan
        for neg in (True, False):
            for t in (0.0, 2.0):
                a = np.asarray(ternary_pattern_from_openness(
                    Z, lookup_pixels=6, threshold_angle=t,
                    use_negative_openness=neg, engine="xla"))
                b = np.asarray(ternary_pattern_from_openness(
                    Z, lookup_pixels=6, threshold_angle=t,
                    use_negative_openness=neg, engine="pallas"))
                assert (a == b).mean() == 1.0, (neg, t)
        # lowest-equivalent LUT composes with the fused kernel
        a = np.asarray(ternary_pattern_from_openness(
            Z, lookup_pixels=6, lowest=True, engine="xla"))
        b = np.asarray(ternary_pattern_from_openness(
            Z, lookup_pixels=6, lowest=True, engine="pallas"))
        np.testing.assert_array_equal(a, b)

    @pytest.mark.heavy
    def test_fused_fast_ladder_and_odd_shapes(self, rng):
        """Fast progressive ladder + non-tile-aligned shape + lookup
        exceeding the tile through the fused openness kernel."""
        from neilpy_tpu.ops.pallas_scan import openness_pallas
        from neilpy_tpu.ops.visibility import openness
        Z = rng.normal(size=(70, 90)).cumsum(axis=0).astype(np.float32)
        p, _ = openness_pallas(Z, cellsize=2, lookup_pixels=23,
                               fast=True, block=(32, 128))
        w = np.asarray(openness(Z, cellsize=2, lookup_pixels=23,
                                fast=True, engine="xla"))
        np.testing.assert_allclose(np.asarray(p), w, atol=1e-4)
        p2, _ = openness_pallas(Z[:64, :], lookup_pixels=40,
                                block=(32, 128))
        w2 = np.asarray(openness(Z[:64, :], lookup_pixels=40,
                                 engine="xla"))
        np.testing.assert_allclose(np.asarray(p2), w2, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 1), (17, 300), (257, 129)])
def test_block_padding_odd_shapes(shape):
    """Odd shapes pad to whole power-of-two blocks (clamped to the
    raster) and crop back to the XLA engine's classes exactly."""
    from neilpy_tpu.ops.pallas_scan import _block_for, DEFAULT_BLOCK
    r = np.random.default_rng(sum(shape))
    Z = r.normal(size=shape).cumsum(axis=0).astype(np.float32)
    BH, BW = _block_for(shape, DEFAULT_BLOCK)
    assert BH <= DEFAULT_BLOCK[0] and BW <= DEFAULT_BLOCK[1]
    assert BH >= min(shape[0], DEFAULT_BLOCK[0])
    assert BW >= min(shape[1], DEFAULT_BLOCK[1])
    G_p = np.asarray(geomorphons_pallas(Z, lookup_pixels=5))
    assert G_p.shape == shape
    np.testing.assert_array_equal(G_p, np.asarray(
        geomorphons(Z, lookup_pixels=5, engine="xla")))


def test_block_must_be_power_of_two(Z):
    with pytest.raises(ValueError, match="powers of two"):
        geomorphons_pallas(Z, lookup_pixels=3, block=(24, 64))


def test_compiled_kernel_refused_on_cpu(Z):
    """No quiet interpreter: a compiled kernel asked for on the CPU
    raises instead of falling back."""
    with pytest.raises(ValueError, match="no compiled form"):
        openness_counts_pallas(Z, lookup_pixels=3, interpret=False)


_MODES = {
    "counts": lambda ps, z: ps.openness_counts_pallas(z, lookup_pixels=50),
    "classes_fast": lambda ps, z: ps.geomorphons_pallas(
        z, lookup_pixels=50, fast=True),
    "extrema": lambda ps, z: ps.directional_extrema_pallas(
        z, lookup_pixels=10),
    "openness": lambda ps, z: ps.openness_pallas(z, lookup_pixels=10),
    "svf": lambda ps, z: ps.skyview_pallas(z, lookup_pixels=10),
    "ternary": lambda ps, z: ps.ternary_pallas(
        z, lookup_pixels=10, use_negative_openness=False),
    "block": lambda ps, z: ps.openness_counts_pallas_block(
        z, (3, 4), (5000, 5000), 10),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_kernel_lowers_to_triton(mode, monkeypatch):
    """Every entry point lowers for CUDA through the Triton route (the
    Python-side Triton lowering runs without a card)."""
    import jax
    import jax.numpy as jnp
    from neilpy_tpu import backend
    from neilpy_tpu.ops import pallas_scan as ps
    monkeypatch.setattr(backend, "_device_platform", lambda: "gpu")
    z = jnp.zeros((300, 200), jnp.float32)
    txt = jax.jit(lambda a: _MODES[mode](ps, a)).trace(z).lower(
        lowering_platforms=("cuda",)).as_text()
    assert txt.count("xla.gpu.triton") == 1
