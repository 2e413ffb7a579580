"""Persistent compiled-executable cache (AOT cache), opt-in.

JAX's persistent compilation cache (``backend.enable_compile_cache``)
keeps compiled XLA programs; this module keeps whole serialized
executables (``jax.experimental.serialize_executable``) so a later
process can skip tracing and lowering too.  It is OFF unless
``NEILPY_AOT_CACHE`` names a directory.

* keyed by jax version, runtime platform, device kind, device count,
  a caller-supplied kernel key (the static configuration), the
  abstract signature of the call (shapes/dtypes), and a content hash
  of the ``neilpy_tpu`` sources — editing ANY package source
  invalidates the cache, so a stale executable can never serve a
  changed kernel;
* written atomically (tmp + rename), safe under concurrent processes;
* fail-open: any error in serialize/deserialize/pickling falls back
  to the plain jitted call and disables the cache for the process.

Scope note: the cache stores single-controller executables for the
process's default device set.  Sharded (``shard_map``/mesh) programs
are intentionally NOT cached — their device assignment is baked into
the executable and test meshes are virtual.

Environment:

* ``NEILPY_AOT_CACHE`` — cache directory; unset, ``0`` or empty: the
  cache is disabled.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading

__all__ = ["CachedKernel", "cache_dir", "clear", "package_fingerprint",
           "is_cached"]

_DISABLED = object()
_lock = threading.Lock()


def cache_dir():
    """Resolved cache directory, or None when the cache is disabled
    (``NEILPY_AOT_CACHE`` unset, ``0`` or empty)."""
    env = os.environ.get("NEILPY_AOT_CACHE")
    if env in (None, "", "0"):
        return None
    # expand ~ and $VARS ourselves: non-shell launchers (systemd, cron,
    # Docker ENV) pass the value verbatim, and an unexpanded
    # '~/aot-cache' would become a literal ./~ directory
    return os.path.expanduser(os.path.expandvars(env))


_pkg_fp_cache = []


def package_fingerprint():
    """Content hash over every ``neilpy_tpu`` package file (sources,
    native binaries, AND data files — a kernel may bake package data
    such as an embedded LUT into its traced constants, so data edits
    must invalidate too; only bytecode caches are skipped).  Coarse on
    purpose: ANY package edit invalidates every cached executable —
    over-invalidation costs a recompile, under-invalidation would
    serve a stale kernel."""
    if _pkg_fp_cache:
        return _pkg_fp_cache[0]
    root = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        if "__pycache__" in dirnames:
            dirnames.remove("__pycache__")
        for fn in sorted(filenames):
            if fn.endswith((".pyc", ".pyo")):
                continue
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    fp = h.hexdigest()[:16]
    _pkg_fp_cache.append(fp)
    return fp


def _runtime_tag():
    import jax
    d = jax.devices()[0]
    return (jax.__version__, jax.default_backend(),
            getattr(d, "device_kind", "?"), jax.device_count())


def _abstract_sig(args):
    import jax

    def one(a):
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            return ("arr", tuple(a.shape), str(a.dtype))
        # A raw Python scalar is REJECTED rather than keyed by value:
        # keying by value would compile + store one multi-MB executable
        # per distinct value (a threshold sweep would recompile the
        # program N times); keying by dtype alone would
        # serve a stale executable if the wrapped jit marked the
        # argument static.  Callers pass jnp.asarray(x) for traced
        # scalars, or fold true configuration into ``key``.
        raise TypeError(
            f"CachedKernel arguments must be arrays; got {type(a).__name__} "
            f"{a!r} — pass jnp.asarray(x) (traced) or move static "
            "configuration into the cache key")

    return tuple(one(x) for x in jax.tree_util.tree_leaves(args))


def clear(directory=None):
    """Remove every cached executable (optionally from an explicit
    directory)."""
    d = directory or cache_dir()
    if not d or not os.path.isdir(d):
        return 0
    n = 0
    for fn in os.listdir(d):
        if fn.endswith(".jaxexec"):
            try:
                os.remove(os.path.join(d, fn))
                n += 1
            except OSError as e:
                import logging
                logging.getLogger(__name__).debug(
                    "could not remove AOT cache entry %s: %s", fn, e)
    return n


def _exec_path(key, sig):
    """Cache-file path for (key, abstract signature) under the current
    runtime + package state, or None when caching is off.  The SINGLE
    place the path is derived — ``CachedKernel._path`` and
    ``is_cached`` must agree bit-for-bit or warmness checks silently
    go always-False (asserted in test_aot)."""
    d = cache_dir()
    if d is None:
        return None
    raw = repr((1, _runtime_tag(), package_fingerprint(),
                str(key), sig))
    return os.path.join(
        d, hashlib.sha256(raw.encode()).hexdigest() + ".jaxexec")


def is_cached(key, shapes_dtypes):
    """True when a ``CachedKernel(fn, key=key)`` call with array
    arguments of the given ``(shape, dtype)`` list would load its
    executable from disk for the CURRENT runtime + package state —
    i.e. no compile would be paid.  Lets callers (bench.py) order
    expensive probes by whether they are warm."""
    import numpy as np
    sig = tuple(("arr", tuple(s), str(np.dtype(dt)))
                for s, dt in shapes_dtypes)
    path = _exec_path(key, sig)
    return path is not None and os.path.exists(path)


class CachedKernel:
    """Wrap a ``jax.jit``-ed callable with a persistent executable
    cache.

    ``fn`` must be the jitted callable (positional args only); ``key``
    identifies the kernel's static configuration (include every
    closed-over static parameter — two configurations with the same
    key and signature would collide).  The first call per signature
    either loads the compiled executable from disk or compiles and
    stores it; later processes skip the compile entirely.

    Calls fall back to ``fn`` itself — identical semantics, no
    caching — when the cache is disabled, when any argument is a
    tracer (the kernel is being inlined into an outer program), or
    when serialization is unsupported on the backend.
    """

    def __init__(self, fn, key):
        self.fn = fn
        self.key = str(key)
        self._mem = {}

    def _path(self, sig):
        return _exec_path(self.key, sig)

    def __call__(self, *args):
        import jax

        if any(isinstance(x, jax.core.Tracer)
               for x in jax.tree_util.tree_leaves(args)):
            return self.fn(*args)
        sig = _abstract_sig(args)
        hit = self._mem.get(sig)
        if hit is _DISABLED:
            return self.fn(*args)
        if hit is not None:
            return hit(*args)
        path = self._path(sig)
        if path is None:
            self._mem[sig] = _DISABLED
            return self.fn(*args)
        compiled = self._load(path)
        if compiled is None:
            compiled = self._compile_and_store(path, args)
        with _lock:
            self._mem[sig] = compiled if compiled is not None \
                else _DISABLED
        if compiled is None:
            return self.fn(*args)
        return compiled(*args)

    def _load(self, path):
        from jax.experimental import serialize_executable as se
        import jax
        try:
            with open(path, "rb") as f:
                blob, in_tree, out_tree = pickle.load(f)
            # pin execution to the default device: the cached programs
            # are single-controller, and the default of "all backend
            # devices" breaks on multi-(virtual-)device hosts
            return se.deserialize_and_load(
                blob, in_tree, out_tree,
                execution_devices=jax.devices()[:1])
        except FileNotFoundError:
            return None
        except Exception as e:
            # corrupt / stale-format / wrong-runtime file: drop it so
            # the next run rebuilds instead of failing forever — but
            # say so, a vanishing cache entry means a multi-minute
            # recompile the user should be able to attribute
            import warnings
            warnings.warn(f"dropping unreadable AOT cache entry "
                          f"{os.path.basename(path)} ({type(e).__name__}: "
                          f"{e}); the kernel will recompile")
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _compile_and_store(self, path, args):
        from jax.experimental import serialize_executable as se
        try:
            compiled = self.fn.lower(*args).compile()
        except Exception:
            return None  # fn not AOT-able (e.g. not a jit wrapper)
        try:
            blob, in_tree, out_tree = se.serialize(compiled)
            payload = pickle.dumps((blob, in_tree, out_tree))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except Exception as e:
            # backend without serialization: still use `compiled`, but
            # note the cache miss will recur every process
            import logging
            logging.getLogger(__name__).debug(
                "AOT executable for %s not persisted (%s): backend "
                "lacks serialization; every process will recompile",
                os.path.basename(path), e)
        return compiled
