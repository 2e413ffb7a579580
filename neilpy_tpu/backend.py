"""The one place that turns the default device's platform into run-time
choices: which ladder engine ``engine="auto"`` takes, whether a Pallas
kernel is interpreted, the mosaic's transfer defaults, and where JAX
keeps its persistent compile cache.

Two platforms are supported: ``"gpu"`` (the compiled Triton kernel)
and ``"cpu"`` (the XLA engine by default; the kernel only in Pallas
interpret mode, which is how the tests exercise it).  Any other
platform raises instead of silently taking a slow path.
"""

from __future__ import annotations

import os

import jax

__all__ = ["platform", "resolve_engine", "resolve_interpret",
           "mosaic_defaults", "enable_compile_cache"]

_SUPPORTED = ("cpu", "gpu")

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_platform():
    return jax.devices()[0].platform


def platform():
    """Platform of the default device: ``"cpu"`` or ``"gpu"``."""
    p = _device_platform()
    if p not in _SUPPORTED:
        raise RuntimeError(f"unsupported JAX platform {p!r}; neilpy_tpu "
                           f"runs on {' and '.join(_SUPPORTED)}")
    return p


def resolve_engine(engine="auto"):
    """``"auto"`` -> ``"pallas"`` on the GPU (the kernel won the on-card
    A/B through ``geomorphons`` for both the exact and the fast ladder;
    PERF.md), ``"xla"`` on the CPU; explicit engines pass through."""
    if engine == "auto":
        return "pallas" if platform() == "gpu" else "xla"
    if engine not in ("xla", "pallas"):
        raise ValueError(f"engine must be 'auto', 'xla' or 'pallas', "
                         f"got {engine!r}")
    return engine


def resolve_interpret(interpret=None):
    """Pallas interpret mode: ``None`` -> True on the CPU (where Pallas
    has only the interpreter), False on the GPU.  Asking for a
    compiled kernel on the CPU raises rather than interpreting
    quietly."""
    p = platform()
    if interpret is None:
        return p == "cpu"
    if not interpret and p == "cpu":
        raise ValueError("the Pallas ladder kernel has no compiled form "
                         "on the CPU: pass interpret=True or use "
                         "engine='xla'")
    return bool(interpret)


def mosaic_defaults(use_pallas=None, wire="auto", prefetch=None):
    """Resolve the mosaic's ``use_pallas`` / ``wire`` / ``prefetch``:
    the kernel where ``resolve_engine`` picks it, the exact wire format
    and no prefetch thread (whether the compact wire or prefetch pays
    over PCIe is not measured yet)."""
    if use_pallas is None:
        use_pallas = resolve_engine() == "pallas"
    if wire == "auto":
        wire = "exact"
    if prefetch is None:
        prefetch = False
    return bool(use_pallas), wire, bool(prefetch)


def enable_compile_cache():
    """Point JAX's persistent compilation cache at
    ``$JAX_COMPILATION_CACHE_DIR`` when it is set, else at
    ``<checkout>/.jax_cache`` (fixed, derived from this file's
    location).  Returns the directory used."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
