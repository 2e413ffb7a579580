"""Persistent compiled-executable cache (neilpy_tpu.aot).

The cache is opt-in (NEILPY_AOT_CACHE); these tests exercise its
machinery on the CPU backend: store/load round trips, result parity,
tracer passthrough, corrupt-file recovery, and the fail-open paths.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from neilpy_tpu import aot


@pytest.fixture
def cachedir(tmp_path, monkeypatch):
    d = str(tmp_path / "aotcache")
    monkeypatch.setenv("NEILPY_AOT_CACHE", d)
    return d


def _kernel():
    return jax.jit(lambda a, s: (a * s + 1.0, (a - s).sum()))


def _files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".jaxexec")) \
        if os.path.isdir(d) else []


def test_compile_store_and_parity(cachedir):
    f = _kernel()
    ck = aot.CachedKernel(f, key="t1")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = ck(a, jnp.float32(2.0))
    want = f(a, jnp.float32(2.0))
    np.testing.assert_array_equal(np.asarray(got[0]),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]),
                                  np.asarray(want[1]))
    assert len(_files(cachedir)) == 1


def test_is_cached_matches_cachedkernel_path(cachedir):
    """``aot.is_cached`` must agree with the path ``CachedKernel``
    actually writes (both derive it via ``_exec_path``): a drift here
    makes every warmness check silently always-False."""
    a = np.ones((7, 3), np.float32)
    s = jnp.float32(2.0)
    sig = [((7, 3), "float32"), ((), "float32")]
    assert not aot.is_cached("warmcheck", sig)
    ck = aot.CachedKernel(_kernel(), key="warmcheck")
    ck(a, s)
    assert aot.is_cached("warmcheck", sig)
    # different key or signature -> not warm
    assert not aot.is_cached("other-key", sig)
    assert not aot.is_cached("warmcheck", [((8, 3), "float32"),
                                           ((), "float32")])


def test_disk_hit_skips_compile(cachedir):
    a = np.ones((4, 4), np.float32)
    s = jnp.float32(3.0)
    ck1 = aot.CachedKernel(_kernel(), key="t2")
    r1 = np.asarray(ck1(a, s)[0])
    # a fresh wrapper (fresh process stand-in) must serve from disk:
    # poison the compile path so any compile attempt fails loudly
    ck2 = aot.CachedKernel(_kernel(), key="t2")
    ck2._compile_and_store = None  # would raise TypeError if invoked
    r2 = np.asarray(ck2(a, s)[0])
    np.testing.assert_array_equal(r1, r2)


def test_signature_and_key_separate_entries(cachedir):
    ck = aot.CachedKernel(_kernel(), key="t3")
    ck(np.ones((2, 2), np.float32), jnp.float32(1.0))
    ck(np.ones((3, 2), np.float32), jnp.float32(1.0))  # new shape
    other = aot.CachedKernel(_kernel(), key="t3b")
    other(np.ones((2, 2), np.float32), jnp.float32(1.0))
    assert len(_files(cachedir)) == 3


def test_tracer_passthrough(cachedir):
    ck = aot.CachedKernel(_kernel(), key="t4")

    @jax.jit
    def outer(a):
        y, s = ck(a, jnp.float32(2.0))
        return y + s

    out = np.asarray(outer(np.ones((2, 3), np.float32)))
    np.testing.assert_allclose(out, -3.0)  # y=3 plus sum(a-s)=-6
    assert len(_files(cachedir)) == 0  # traced call never hits disk


def test_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("NEILPY_AOT_CACHE", "0")
    assert aot.cache_dir() is None
    ck = aot.CachedKernel(_kernel(), key="t5")
    out = ck(np.ones((2, 2), np.float32), jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(out[0]), 2.0)


def test_default_off_on_cpu(monkeypatch):
    """Off by default everywhere: no platform turns the cache on
    without NEILPY_AOT_CACHE."""
    from neilpy_tpu import backend
    monkeypatch.delenv("NEILPY_AOT_CACHE", raising=False)
    for plat in ("cpu", "gpu"):
        monkeypatch.setattr(backend, "_device_platform", lambda: plat)
        assert aot.cache_dir() is None


def test_corrupt_file_recovered(cachedir):
    a = np.ones((5, 5), np.float32)
    s = jnp.float32(2.0)
    ck = aot.CachedKernel(_kernel(), key="t6")
    want = np.asarray(ck(a, s)[0])
    (fn,) = _files(cachedir)
    path = os.path.join(cachedir, fn)
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    ck2 = aot.CachedKernel(_kernel(), key="t6")
    # the drop must be VISIBLE (VERDICT r4 #7): a vanished cache entry
    # costs a multi-minute recompile the user should hear about
    with pytest.warns(UserWarning, match="unreadable AOT cache entry"):
        got = np.asarray(ck2(a, s)[0])
    np.testing.assert_array_equal(got, want)
    # the corrupt file was replaced by a fresh valid one
    (fn2,) = _files(cachedir)
    with open(os.path.join(cachedir, fn2), "rb") as f:
        blob, in_tree, out_tree = pickle.load(f)
    assert isinstance(blob, bytes) and len(blob) > 0


def test_non_jit_fn_falls_back(cachedir):
    plain = lambda a: a + 1  # no .lower: not AOT-able
    ck = aot.CachedKernel(plain, key="t7")
    out = ck(np.ones(3, np.float32))
    np.testing.assert_allclose(np.asarray(out), 2.0)
    assert len(_files(cachedir)) == 0
    # and the fallback is remembered (second call same path)
    out = ck(np.ones(3, np.float32))
    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_clear(cachedir):
    ck = aot.CachedKernel(_kernel(), key="t8")
    ck(np.ones((2, 2), np.float32), jnp.float32(1.0))
    assert len(_files(cachedir)) == 1
    assert aot.clear() == 1
    assert len(_files(cachedir)) == 0


def test_package_fingerprint_stable():
    assert aot.package_fingerprint() == aot.package_fingerprint()
    assert len(aot.package_fingerprint()) == 16


def test_mosaic_tile_kernel_uses_cache(cachedir):
    """End-to-end: a small mosaic run populates the cache and a second
    run (fresh kernel instance) still matches the direct computation."""
    from neilpy_tpu.pipelines import mosaic as M

    rng = np.random.default_rng(0)
    Z = rng.normal(size=(256, 256)).astype(np.float32).cumsum(axis=0)
    kw = dict(cellsize=1.0, lookup_pixels=8, windows=np.array([1, 2]),
              gi_radius=2, tile_size=128, products=("geomorphons",
                                                    "objects", "moran"))
    M._make_tile_kernel.cache_clear()
    g1, o1, m1 = M.mosaic_terrain_products(Z, **kw)
    assert len(_files(cachedir)) >= 1
    M._make_tile_kernel.cache_clear()  # fresh CachedKernel -> disk load
    g2, o2, m2 = M.mosaic_terrain_products(Z, **kw)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(m1, m2)


def test_python_scalar_args_rejected(cachedir):
    """Raw Python scalars are an explicit contract error: keying by
    value would compile + store one executable per distinct value, and
    keying by dtype alone could serve a stale executable if the wrapped
    jit marked the argument static.  Callers pass jnp.asarray(x)."""
    ck = aot.CachedKernel(_kernel(), key="t9")
    with pytest.raises(TypeError, match="jnp.asarray"):
        ck(np.ones((2, 2), np.float32), 2.0)
    # array-typed scalars stay fine
    out = ck(np.ones((2, 2), np.float32), jnp.float32(2.0))
    np.testing.assert_allclose(np.asarray(out[0]), 3.0)


def test_cache_dir_env_expands_user_and_vars(monkeypatch, tmp_path):
    monkeypatch.setenv("NEILPY_AOT_CACHE", "~/somewhere/aot")
    assert aot.cache_dir() == os.path.join(os.path.expanduser("~"),
                                           "somewhere", "aot")
    monkeypatch.setenv("NPY_TEST_BASE", str(tmp_path))
    monkeypatch.setenv("NEILPY_AOT_CACHE", "$NPY_TEST_BASE/aot")
    assert aot.cache_dir() == str(tmp_path / "aot")


def test_package_fingerprint_covers_data_files(monkeypatch, tmp_path):
    """A kernel may bake package DATA (e.g. the embedded swiss-LUT
    residual) into its traced constants, so editing a data file must
    invalidate the cache exactly like editing a .py — while bytecode
    caches must not perturb the fingerprint."""
    pkg = tmp_path / "fakepkg"
    (pkg / "__pycache__").mkdir(parents=True)
    (pkg / "mod.py").write_text("x = 1\n")
    (pkg / "table.bin").write_bytes(b"\x01\x02\x03")

    monkeypatch.setattr(aot, "__file__", str(pkg / "__init__.py"))
    monkeypatch.setattr(aot, "_pkg_fp_cache", [])
    fp1 = aot.package_fingerprint()

    monkeypatch.setattr(aot, "_pkg_fp_cache", [])
    (pkg / "__pycache__" / "mod.cpython-311.pyc").write_bytes(b"junk")
    assert aot.package_fingerprint() == fp1  # bytecode is ignored

    monkeypatch.setattr(aot, "_pkg_fp_cache", [])
    (pkg / "table.bin").write_bytes(b"\x01\x02\x04")
    assert aot.package_fingerprint() != fp1  # data edits invalidate
