"""First-class performance observability: throughput counters and
device-trace capture.

The reference had no tracing/profiling beyond manual ``time.time()``
pairs in a scratch script (SURVEY.md §5; reference
neilpy/test_neilpy.py:30-33).  Here throughput measurement and XLA
trace capture are part of the framework:

* ``Throughput`` — a context manager / decorator that measures wall
  time around device work with an honest synchronization (tiny
  readback, robust to async dispatch) and
  reports Mpix/s / Mpts/s style rates.
* ``trace`` — wraps ``jax.profiler.trace`` so any pipeline run can be
  captured for TensorBoard/Perfetto without touching user code.
* ``compile_report`` — lowers+compiles a jitted callable and reports
  per-program compile wall time and (when the backend exposes it)
  HLO cost-analysis FLOPs/bytes — the "is XLA fusing what I think"
  sanity tool.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

__all__ = ["Throughput", "sync", "trace", "compile_report"]


def sync(x):
    """Block until device work producing ``x`` is done.  Pulls ONE
    element to host, which also waits for every producer."""
    import jax
    leaves = [l for l in jax.tree_util.tree_leaves(x)
              if hasattr(l, "ravel")]
    if leaves:
        np.asarray(leaves[-1].ravel()[:1])
    return x


class Throughput:
    """Measure items/second around device work.

    >>> with Throughput("geomorphons", items=Z.size, unit="pix") as tp:
    ...     tp.result = geomorphons(Z, cellsize=10, lookup_pixels=50)
    geomorphons: 1234.5 Mpix/s (6.8 ms for 8.4 Mpix)

    Assign the device output to ``tp.result`` so the exit-time sync
    charges all pending work to the measured interval.
    """

    def __init__(self, name, items, unit="pix", quiet=False):
        self.name = name
        self.items = int(items)
        self.unit = unit
        self.quiet = quiet
        self.result = None
        self.seconds = None
        self.rate = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            sync(self.result)
        self.seconds = time.perf_counter() - self._t0
        self.rate = self.items / self.seconds if self.seconds else 0.0
        if not self.quiet and exc_type is None:
            if self.rate >= 1e6:
                rate = f"{self.rate / 1e6:,.1f} M{self.unit}/s"
            else:
                rate = f"{self.rate / 1e3:,.1f} K{self.unit}/s"
            print(f"{self.name}: {rate} ({self.seconds * 1e3:.1f} ms "
                  f"for {self.items / 1e6:.2f} M{self.unit})")
        return False


@contextlib.contextmanager
def trace(log_dir="/tmp/neilpy_tpu_trace"):
    """Capture a device trace viewable in TensorBoard / Perfetto:

    >>> with trace("/tmp/tr"):
    ...     sync(smrf(x, y, z, 1, 18))
    """
    import jax
    with jax.profiler.trace(log_dir):
        yield log_dir


def compile_report(fn, *args, name=None, **kwargs):
    """Lower + compile ``fn(*args, **kwargs)`` and report compile wall
    time plus XLA cost-analysis estimates when available.  Returns a
    dict (and prints a one-liner)."""
    import jax
    name = name or getattr(fn, "__name__", "fn")
    t0 = time.perf_counter()
    lowered = jax.jit(fn).lower(*args, **kwargs)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    report = {"name": name, "lower_s": t_lower, "compile_s": t_compile}
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        for k in ("flops", "bytes accessed"):
            if cost and k in cost:
                report[k.replace(" ", "_")] = float(cost[k])
    except Exception as e:
        # cost_analysis is backend-dependent; the report simply
        # omits flops/bytes where a backend lacks it
        import logging
        logging.getLogger(__name__).debug(
            "cost_analysis unavailable for %s: %s", name, e)
    flops = report.get("flops")
    extra = f", {flops / 1e9:.2f} GFLOP" if flops else ""
    print(f"compile[{name}]: lower {t_lower:.2f}s, compile "
          f"{t_compile:.2f}s{extra}")
    return report
