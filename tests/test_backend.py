"""The backend resolver, the compile-cache helper, installations without
pandas, and the precision of the float32 convolution."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from neilpy_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on(monkeypatch):
    """Pretend the default device has the given platform."""
    def set_platform(p):
        monkeypatch.setattr(backend, "_device_platform", lambda: p)
    return set_platform


def test_resolve_engine_cpu():
    assert backend.platform() == "cpu"
    assert backend.resolve_engine("auto") == "xla"
    assert backend.resolve_engine("pallas") == "pallas"
    assert backend.resolve_engine("xla") == "xla"


def test_resolve_engine_gpu(on):
    on("gpu")
    assert backend.resolve_engine() == "pallas"
    assert backend.resolve_engine("xla") == "xla"


def test_unknown_platform_raises(on):
    on("rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.resolve_engine("auto")
    with pytest.raises(RuntimeError):
        backend.resolve_interpret()


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine must be"):
        backend.resolve_engine("mosaic")


def test_resolve_interpret_per_platform(on):
    assert backend.resolve_interpret() is True
    assert backend.resolve_interpret(True) is True
    on("gpu")
    assert backend.resolve_interpret() is False
    assert backend.resolve_interpret(False) is False


def test_compiled_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="no compiled form"):
        backend.resolve_interpret(False)


def test_mosaic_defaults(on):
    assert backend.mosaic_defaults() == (False, "exact", False)
    on("gpu")
    assert backend.mosaic_defaults() == (True, "exact", False)
    # explicit choices pass through
    assert backend.mosaic_defaults(False, "compact", True) == (
        False, "compact", True)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_fixed_default(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert backend.enable_compile_cache() == want
    assert backend.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_import_and_run_without_pandas():
    """``import neilpy_tpu`` and the geomorphons / SMRF paths need only
    JAX, numpy and scipy."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np, neilpy_tpu as nt\n"
        "Z = np.random.default_rng(0).normal(size=(40, 50))"
        ".cumsum(0).astype(np.float32)\n"
        "assert nt.geomorphons(Z, lookup_pixels=4).shape == Z.shape\n"
        "r = np.random.default_rng(1)\n"
        "x, y = r.uniform(0, 30, 2000), r.uniform(0, 20, 2000)\n"
        "z = r.normal(0, .1, 2000)\n"
        "assert nt.smrf(x, y, z, 1, 3)[3].shape == (2000,)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_convolve_asks_for_highest_precision():
    """A float32 convolution must not be left to TF32 on the GPU."""
    from neilpy_tpu.ops.surface import convolve2d_nearest
    k = np.arange(9, dtype=np.float32).reshape(3, 3)
    txt = jax.jit(lambda a: convolve2d_nearest(a, k)).lower(
        np.zeros((16, 16), np.float32)).as_text()
    conv = [ln for ln in txt.splitlines() if "convolution" in ln]
    assert conv and all("HIGHEST" in ln for ln in conv)
