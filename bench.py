"""Benchmark harness: one process, on the GPU only.

Prints one JSON record per headline on stdout,
``{"metric", "value", "unit", "vs_baseline", "device": {...}}``, where
``device`` names the platform, device kind, device count and the card's
name and power limit.  Secondary numbers go to stderr, after one line
naming the same device.  Without a GPU it exits non-zero and prints no
record.

Headline: geomorphon classification throughput (Mpix/s) at
lookup_pixels=50 on a 10,000^2 raster through the public
``geomorphons`` — the reference's Poland EU-DEM workload (~1e8 px at
lookup 50 took ~26-42 min on CPU, i.e. ~0.2 Mpix/s; BASELINE.md).

Run: ``python bench.py`` (compilation is set-up and is excluded from
the timed calls; the persistent compile cache is
``neilpy_tpu.backend.enable_compile_cache``).
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_MPIX_S = 0.2  # reference CPU: ~1e8 px / ~30 min at lookup=50
BENCH_LOOKUP = 50
SCALE_SIDE = 10_000


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_info():
    """``name, power.limit`` of the card, read in a child process that
    never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unavailable"


def device_fields():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def _warm_time(f, k=3):
    """(first-call seconds incl. compile, best warm seconds of k)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(f())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(k):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        warm.append(time.perf_counter() - t0)
    return first, min(warm)


def _terrain(side, seed=0):
    """Seeded random-walk terrain made on the device (f32)."""
    import jax
    import jax.numpy as jnp
    k1, k2 = jax.random.split(jax.random.key(seed))
    Z = (jnp.cumsum(jax.random.normal(k1, (side, side)), axis=0)
         + jnp.cumsum(jax.random.normal(k2, (side, side)), axis=1))
    return jax.block_until_ready(Z.astype(jnp.float32))


def bench_geomorphons(Z, fast=False, engine="auto"):
    """Mpix/s of ``geomorphons`` at lookup 50 through the public entry."""
    import neilpy_tpu as nt
    first, dt = _warm_time(lambda: nt.geomorphons(
        Z, cellsize=10, lookup_pixels=BENCH_LOOKUP, threshold_angle=1,
        fast=fast, engine=engine))
    mpix = Z.size / dt / 1e6
    log(f"geomorphons {Z.shape} lookup={BENCH_LOOKUP} fast={fast} "
        f"engine={engine}: set-up {first:.2f}s, warm {dt * 1e3:.1f} ms "
        f"= {mpix:.0f} Mpix/s")
    return mpix, dt


def bench_ladder_ab(Z):
    """Kernel vs XLA engine through ``geomorphons``, taken in turns
    (xla, kernel, kernel, xla) for the exact and the fast ladder."""
    out = {}
    for fast in (False, True):
        times = {"xla": [], "pallas": []}
        for eng in ("xla", "pallas", "pallas", "xla"):
            times[eng].append(bench_geomorphons(Z, fast, eng)[1])
        out["fast" if fast else "exact"] = times
        log(f"ladder A/B fast={fast}: xla {times['xla']} s, "
            f"kernel {times['pallas']} s")
    return out


def bench_gridding():
    """Lidar gridding: host f64 binning + device scatter-min."""
    from neilpy_tpu.ops.pointgrid import create_dem
    n = 20_000_000
    rng = np.random.default_rng(1)
    x = rng.uniform(500000, 502000, n)
    y = rng.uniform(4200000, 4202000, n)
    z = rng.normal(300, 30, n).astype(np.float32)
    first, dt = _warm_time(lambda: create_dem(x, y, z, cellsize=1,
                                              bin_type="min")[0], k=2)
    log(f"create_dem {n} pts: set-up {first:.2f}s, warm {dt:.2f}s = "
        f"{n / dt / 1e6:.1f} Mpts/s end to end")


def bench_inpaint():
    """Springs inpaint at 4096^2 with a 30% contiguous NaN hole."""
    import jax.numpy as jnp
    from neilpy_tpu.ops.inpaint import inpaint_nans_by_springs
    Z = np.array(_terrain(4096, seed=2))  # writable host copy
    Z[900:3200, 800:3000] = np.nan
    Zd = jnp.asarray(Z)
    first, dt = _warm_time(lambda: inpaint_nans_by_springs(Zd), k=2)
    _, info = inpaint_nans_by_springs(Zd, return_info=True)
    log(f"inpaint springs 4096^2 / 30% NaN: {info['iterations']} CG "
        f"iterations, converged={info['converged']}, set-up "
        f"{first:.2f}s, warm {dt:.3f}s")


def bench_stats(Z):
    """Getis-Ord Gi* (disk r=5, 13) and local Moran's I (r=3)."""
    from neilpy_tpu.ops.stats import rasterGi, local_morans_i
    from neilpy_tpu.core.codes import disk
    for r in (5, 13):
        fp = np.asarray(disk(r))
        first, dt = _warm_time(
            lambda: rasterGi(Z, footprint=fp, star=True)[0])
        log(f"rasterGi* disk r={r} {Z.shape}: set-up {first:.2f}s, "
            f"warm {dt * 1e3:.1f} ms = {Z.size / dt / 1e6:.0f} Mpix/s")
    first, dt = _warm_time(lambda: local_morans_i(Z, footprint=3))
    log(f"local Moran's I r=3 {Z.shape}: set-up {first:.2f}s, warm "
        f"{dt * 1e3:.1f} ms = {Z.size / dt / 1e6:.0f} Mpix/s")


def bench_sharded_overhead(Z):
    """``sharded_geomorphons`` on a 1x1 mesh vs the direct call."""
    import neilpy_tpu as nt
    from neilpy_tpu.dist import make_mesh, sharded_geomorphons
    mesh = make_mesh(shape=(1, 1))
    kw = dict(cellsize=10, lookup_pixels=BENCH_LOOKUP, threshold_angle=1)
    _, direct = _warm_time(lambda: nt.geomorphons(Z, **kw))
    _, shard = _warm_time(lambda: sharded_geomorphons(Z, mesh=mesh, **kw))
    log(f"sharded 1x1 mesh: direct {direct * 1e3:.1f} ms, sharded "
        f"{shard * 1e3:.1f} ms ({100 * (shard / direct - 1):+.1f}%)")


def bench_mosaic():
    """16,384^2 mosaic wall time from host arrays, two product sets."""
    from neilpy_tpu.pipelines.mosaic import mosaic_terrain_products
    N = 16384
    Z = np.asarray(_terrain(N, seed=3))
    Zi16 = np.clip(np.round(Z), -32000, 32000).astype(np.int16)
    for name, src, kw in [
            ("duo_int16", Zi16, dict(products=("geomorphons", "objects"))),
            ("trio_f32", Z, dict(gi_radius=3))]:
        kw.update(lookup_pixels=BENCH_LOOKUP, windows=5, tile_size=4096)
        t0 = time.perf_counter()
        mosaic_terrain_products(src[:4096, :4096], **kw)
        warm = time.perf_counter() - t0
        ps = {}
        t0 = time.perf_counter()
        mosaic_terrain_products(src, phase_stats=ps, **kw)
        dt = time.perf_counter() - t0
        log(f"mosaic[{name}] 16384^2: set-up {warm:.1f}s, wall {dt:.1f}s "
            f"= {N * N / dt / 1e6:.1f} Mpix/s; phases "
            f"{ {k: round(v, 2) for k, v in sorted(ps.items())} }")


def _emit_record(mpix_s, device):
    print(json.dumps({
        "metric": "geomorphons_throughput_lookup50",
        "value": round(mpix_s, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 1),
        "device": device,
    }), flush=True)


def main():
    from neilpy_tpu.backend import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py measures the GPU and found none "
                 f"(platform {jax.devices()[0].platform!r})")
    device = device_fields()
    log(f"device: {json.dumps(device)}")
    Z = _terrain(SCALE_SIDE)
    mpix, _ = bench_geomorphons(Z)
    _emit_record(mpix, device)
    bench_geomorphons(Z, fast=True)
    bench_ladder_ab(Z)
    bench_sharded_overhead(Z)
    bench_stats(Z[:8192, :8192])
    del Z
    bench_gridding()
    bench_inpaint()
    bench_mosaic()


if __name__ == "__main__":
    main()
