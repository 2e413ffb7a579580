"""Host-orchestrated tiling for rasters bigger than device memory,
with tile-granular checkpoint/resume.

This is the single-chip complement to the mesh sharding in
``dist.api``: the reference used ``apply_parallel(func, Z, tile,
overlap)`` (test_neilpy.py:45) both for parallelism *and* for memory;
on a mesh the devices handle parallelism, and this module handles the
out-of-core case — stream overlapping tiles through the device,
writing results into a (memory-mapped) output with optional completed-
tile tracking so a 100k x 100k mosaic job can resume after
interruption (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["tiled_apply", "apply_parallel", "TileCheckpoint"]


class TileCheckpoint:
    """Tracks completed tiles in a sidecar JSON so an interrupted tiled
    run resumes where it left off."""

    def __init__(self, path):
        self.path = path
        self.done = set()
        if path and os.path.exists(path):
            self.done = set(map(tuple, json.load(open(path))))

    def is_done(self, key):
        return tuple(key) in self.done

    def mark(self, key):
        self.done.add(tuple(key))
        if self.path:
            tmp = self.path + ".tmp"
            json.dump(sorted(self.done), open(tmp, "w"))
            os.replace(tmp, self.path)


# upload band size for the device-resident input path: ~32 MB rows per
# device_put keeps several transfers in flight while staying far below
# stripe granularity; module-level so tests can shrink it to exercise
# multi-band stripe stitching on small rasters
_BAND_BYTES = 32 << 20


def _is_device_array(a):
    import jax
    return isinstance(a, jax.Array)


def _pack_device(res):
    """Byte-pack cropped device products into ONE uint8 buffer so the
    tile needs a single device->host transfer.  Returns (packed, specs) where specs drives
    ``_unpack_host``.

    Layout: products are COLUMN BLOCKS — each (H, W) product becomes
    (H, W*nb) bytes (per-element bytes adjacent) and blocks concatenate
    along axis 1, giving (H, W*sum(nb)).  A per-pixel interleave
    (concat on a trailing byte axis) measured ~70x slower to unpack on
    the host: every access is a 3-byte-stride gather numpy cannot
    vectorize (1087 ms vs 16 ms per 4096^2 tile — the single-vCPU host
    was the mosaic bottleneck, not the wire)."""
    import jax.numpy as jnp
    from jax import lax
    parts = []
    specs = []
    for a in res:
        H, W = a.shape
        if a.dtype == jnp.bool_ or a.dtype.itemsize == 1:
            b = a.astype(jnp.uint8)
            nb = 1
        else:
            nb = a.dtype.itemsize
            b = lax.bitcast_convert_type(a, jnp.uint8).reshape(H, W * nb)
        specs.append((np.dtype(a.dtype), nb))
        parts.append(b)
    return jnp.concatenate(parts, axis=1), specs


def _unpack_host(buf, specs):
    """Invert ``_pack_device`` on the host copy: contiguous column-
    block slices + zero-copy dtype views (tens of ms per 4096^2
    tile).

    ``nb`` (bytes per pixel) may be FRACTIONAL for sub-byte planes —
    a bit-packed boolean plane contributes nb=1/8, i.e. W/8 byte
    columns; such planes come back as their raw uint8 columns for the
    caller's ``decode`` to expand (np.unpackbits)."""
    H = buf.shape[0]
    W = int(round(buf.shape[1] / sum(nb for _, nb in specs)))
    out = []
    ofs = 0
    for dt, nb in specs:
        cols = int(round(nb * W))
        chunk = buf[:, ofs:ofs + cols]
        ofs += cols
        if nb < 1:
            out.append(np.ascontiguousarray(chunk))   # packed bits
        elif nb == 1:
            out.append(chunk.astype(dt) if dt != np.uint8
                       else np.ascontiguousarray(chunk))
        else:
            out.append(np.ascontiguousarray(chunk).view(dt))
    return tuple(out)


def _banded_put(block, dev_state, chunk_bytes=24 << 20):
    """Upload a host tile block as several in-flight ``device_put``
    bands + one jitted concatenate (cached per band layout) — the
    same 2-5x monolithic-vs-chunked transfer asymmetry that
    ``_stage_readback`` exploits on the way down, applied to the way
    up.  Below one chunk it is a plain device_put."""
    import jax
    import jax.numpy as jnp
    n = max(1, min(block.shape[0], -(-block.nbytes // chunk_bytes)))
    if n == 1:
        return jax.device_put(block)
    step = -(-block.shape[0] // n)
    bands = [jax.device_put(np.ascontiguousarray(block[i:i + step]))
             for i in range(0, block.shape[0], step)]
    if "concat" not in dev_state:
        dev_state["concat"] = jax.jit(
            lambda *bs: jnp.concatenate(bs, axis=0))
    return dev_state["concat"](*bands)


_ASYNC_COPY_WARNED = False


def _start_host_copy(x):
    """Fire-and-forget ``copy_to_host_async`` prefetch hint; a backend
    without it just pays the synchronous copy at collect time (logged
    once per process so the slower path is attributable)."""
    global _ASYNC_COPY_WARNED
    try:
        x.copy_to_host_async()
    except Exception as e:
        if not _ASYNC_COPY_WARNED:
            _ASYNC_COPY_WARNED = True
            import logging
            logging.getLogger(__name__).debug(
                "copy_to_host_async unsupported (%s); readbacks will "
                "be synchronous", e)


def _stage_readback(a, chunk_bytes=6 << 20):
    """Split a device array into row chunks and start their host
    copies immediately (``copy_to_host_async``): firing the copies at
    dispatch time overlaps them with later tiles' uploads and
    compute."""
    if not _is_device_array(a):
        return [a]
    n = max(1, min(a.shape[0], -(-a.nbytes // chunk_bytes)))
    step = -(-a.shape[0] // n)
    chunks = [a[i:i + step] for i in range(0, a.shape[0], step)]
    for c in chunks:
        _start_host_copy(c)
    return chunks


def _collect_readback(chunks):
    if len(chunks) == 1:
        return np.asarray(chunks[0])
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


def tiled_apply(fn, Z, tile_size, overlap, out=None, out_dtype=None,
                checkpoint=None, progress=False, pipeline_depth=2,
                decode=None, device_input="auto",
                device_input_budget=4 << 30, wire_fn=None,
                wire_specs=None, mesh=None, mesh_wire_fn=None,
                phase_stats=None, prefetch=False):
    """Apply ``fn`` (array -> array, same HxW) to overlapping tiles of
    ``Z``, cropping the overlap — semantics of
    ``skimage.util.apply_parallel(fn, Z, tile_size, overlap)``
    as used by the reference (test_neilpy.py:35-47).

    ``out`` may be a preallocated (memory-mapped) array; ``checkpoint``
    a path for tile-granular resume.  ``fn`` typically wraps a jitted
    kernel; tiles have uniform shape (edge tiles are padded, then
    cropped) so one compilation serves every tile.

    ``fn`` may return a tuple of same-shaped rasters (a fused
    multi-product tile kernel); the return value is then a tuple of
    output arrays (and ``out``/``out_dtype``, if given, tuples too).

    The tile stream is PIPELINED: up to ``pipeline_depth`` tiles stay
    in flight (JAX dispatch is asynchronous, so tile N+1's host pad,
    upload and compute overlap tile N's readback), overlap crops run
    on device before transfer, multi-product tiles are byte-packed
    into one buffer, and readbacks are chunked with async host copies
    started at dispatch time.  ``decode`` (host tuple -> tuple) maps a
    wire encoding back to the caller's products per tile, before
    storing into ``out``.  Results are stored and checkpoint-marked
    only after their readback completes, so kill-and-resume semantics
    are unchanged.

    When the whole input fits in the device budget
    (``device_input='auto'``), it is uploaded ONCE, edge-padded on
    device, and every tile window is a device-side ``dynamic_slice`` —
    no per-tile host->device transfer at all.  Inputs over the budget
    (the true out-of-core case) stream tile-by-tile as before.

    ``wire_fn`` is the minimum-dispatch fast path: a single jitted callable
    ``wire_fn(block) -> tuple of row-chunk arrays`` that crops the
    overlap, byte-packs the products, and splits the wire buffer
    internally, so each tile costs ONE dispatch.  ``wire_specs`` (the
    ``_unpack_host`` spec list) describes the packing; ``decode`` maps
    unpacked wire products back to caller products.  ``fn`` is ignored
    when ``wire_fn`` is given.

    ``mesh`` + ``mesh_wire_fn`` compose the tile stream with MULTI-CHIP
    execution (BASELINE config 5: out-of-core AND mesh-sharded at
    once): tiles are dispatched in groups of ``D = mesh.size``, stacked
    as a host ``(D, B, B)`` batch, device_put sharded over the mesh's
    single flattened axis (one tile per device), and
    ``mesh_wire_fn(blocks) -> (D, tile_size, n_bytes)`` runs the fused
    tile program per shard (a shard_map with NO collective — each tile
    carries its own halo).  Per-device output shards are read back
    independently and checkpoint-marked per TILE, so kill-and-resume
    works mid-group.  A final partial group pads with copies of its
    last tile (discarded on readback).
    """
    from collections import deque
    import time as _time

    # Wall-clock observability for the out-of-core loop (profiling is
    # first-class here — SURVEY §5): pass ``phase_stats={}`` and the
    # dict accumulates cumulative seconds spent in each phase —
    # 'host_read' (source window + pad) and 'upload' (device_put
    # dispatch) on the prefetch thread; 'dispatch' (kernel call +
    # async-copy starts), 'readback_wait' (blocking on device->host
    # copies) and 'store_wait' (writer-thread backpressure) on the
    # dispatch thread — plus 'tiles' and 'total'.  Phases overlap each
    # other and device work by design, so they need not sum to
    # 'total'; a large 'readback_wait' means the wire is the
    # bottleneck, a large 'host_read'/'store_wait' means the host is.
    _ps = phase_stats if phase_stats is not None else {}
    import threading as _threading
    _ps_lock = _threading.Lock()

    def _phase(name, t0):
        # locked: the prefetch producer (host_read/upload) and the
        # dispatch thread (dispatch/readback_wait/store_wait) both
        # accumulate here; an unlocked read-modify-write would drop
        # one side's seconds between the get and the set
        dt = _time.perf_counter() - t0
        with _ps_lock:
            _ps[name] = _ps.get(name, 0.0) + dt

    # Accept lazy 2-D sources (e.g. io.geotiff.GeoTiffSource, np.memmap)
    # without materializing: anything with shape/dtype/__getitem__ is
    # consumed window-by-window in the streaming path below.
    if not (hasattr(Z, "shape") and hasattr(Z, "dtype")
            and hasattr(Z, "__getitem__")):
        Z = np.asarray(Z)
    H, W = Z.shape
    ts = int(tile_size)
    ov = int(overlap)
    ckpt = TileCheckpoint(checkpoint) if checkpoint else None
    multi = None
    if out is not None:
        if isinstance(out, (tuple, list)):
            out = tuple(out)
            multi = True
        else:
            out = (out,)
            multi = False

    n_ty = -(-H // ts)
    n_tx = -(-W // ts)
    inflight = deque()

    if device_input == "auto":
        # the device-resident path computes in JAX's canonical dtype
        # (f64/int64 become f32/int32 with x64 off) — 'auto' keeps the
        # dtype-exact host path for those; explicit True opts in to
        # canonicalization
        from jax.dtypes import canonicalize_dtype
        canonical = canonicalize_dtype(Z.dtype) == Z.dtype
        device_input = canonical and Z.nbytes <= int(device_input_budget)
    dev_state = {}

    def _device_block(r0, c0):
        """Uniform (ts+2ov)^2 tile window sliced from a device-resident
        STRIPE of the raster (lazily uploaded on the first computed
        tile, so a fully-checkpointed resume never pays the upload).

        The upload is BANDED (~32 MB row bands), LAZY, and
        PER-TILE-ROW: bands upload only when the stripe that needs
        them is built, and each tile's compute depends only on its own
        stripe, so with the prefetch thread row k+1's upload rides
        under row k's readbacks.  Dtype is
        PRESERVED (apply_parallel drop-in semantics): coercion is the
        kernel's decision, not the transport's."""
        import jax
        import jax.numpy as jnp
        from jax import lax
        if "bands" not in dev_state:
            band = max(1, _BAND_BYTES // max(W * Z.dtype.itemsize, 1))
            dev_state["band_rows"] = band
            dev_state["bands"] = [None] * (-(-H // band))
            dev_state["stripes"] = {}
            dev_state["slicer"] = jax.jit(
                lambda a, c: lax.dynamic_slice(
                    a, (jnp.int32(0), c), (ts + 2 * ov, ts + 2 * ov)))
            from functools import partial as _partial

            @_partial(jax.jit,
                      static_argnames=("off", "take", "tp", "bp", "pr"))
            def _build(bs, off, take, tp, bp, pr):
                z = (jnp.concatenate(bs, axis=0) if len(bs) > 1
                     else bs[0])
                return jnp.pad(z[off:off + take], ((tp, bp), (ov, pr)),
                               mode="edge")

            dev_state["builder"] = _build
        ti = r0 // ts
        stripes = dev_state["stripes"]
        if ti not in stripes:
            # stripe = original rows [r0-ov, r0+ts+ov) with edge
            # replication outside the raster (identical values to
            # slicing a whole edge-padded raster) and the same column
            # padding the whole-raster path applied
            band = dev_state["band_rows"]
            lo, hi = r0 - ov, r0 + ts + ov
            b0 = max(lo, 0) // band
            b1 = -(-min(hi, H) // band)
            # LAZY per-stripe upload: each stripe uploads only its own
            # bands, so on the prefetch thread row k+1's upload
            # interleaves with row k's readbacks
            bands = dev_state["bands"]
            for b in range(b0, b1):
                if bands[b] is None:
                    bands[b] = jax.device_put(
                        np.asarray(Z[b * band:(b + 1) * band]))
            off = max(lo, 0) - b0 * band
            take = min(hi, H) - max(lo, 0)
            tp, bp = max(-lo, 0), max(hi - H, 0)
            pr = n_tx * ts - W + ov
            # keep only this stripe: tiles stream row-major, and a
            # previous stripe still feeding in-flight kernels stays
            # alive through those computations' own references
            stripes.clear()
            stripes[ti] = dev_state["builder"](
                tuple(dev_state["bands"][b0:b1]), off=off, take=take,
                tp=tp, bp=bp, pr=pr)
        return dev_state["slicer"](stripes[ti], np.int32(c0))

    def store(key, bounds, res):
        """Decode, crop, and store one tile's wire products; mark the
        checkpoint only after the data is safely in ``out``.  Runs on
        the single writer thread: decode + (memory-mapped) output
        writes overlap the dispatch loop's transfers instead of
        serializing with them (measured ~0.8 s/tile of disk write at
        tile 4096 on the one-vCPU host)."""
        nonlocal out
        r0, r1, c0, c1 = bounds
        if decode is not None:
            res = decode(res)
        res = tuple(a[: r1 - r0, : c1 - c0] for a in res)
        if out is None:
            dts = (out_dtype if isinstance(out_dtype, (tuple, list))
                   else (out_dtype,) * len(res))
            out = tuple(np.empty((H, W), dtype=dt or a.dtype)
                        for dt, a in zip(dts, res))
        for o, a in zip(out, res):
            o[r0:r1, c0:c1] = a
        if ckpt:
            ckpt.mark(key)
        if progress:
            print(f"tile {key} / ({n_ty},{n_tx})", flush=True)

    from concurrent.futures import ThreadPoolExecutor
    writer = ThreadPoolExecutor(1)  # ONE thread: keeps store order,
    store_futs = deque()            # and so checkpoint kill-safety

    def submit_store(key, bounds, res):
        store_futs.append(writer.submit(store, key, bounds, res))
        t0 = _time.perf_counter()
        while len(store_futs) > 8:
            store_futs.popleft().result()
        _phase("store_wait", t0)

    def drain_stores():
        t0 = _time.perf_counter()
        while store_futs:
            store_futs.popleft().result()
        writer.shutdown(wait=True)
        _phase("store_wait", t0)

    def flush_one():
        key, bounds, payload, specs = inflight.popleft()
        t0 = _time.perf_counter()
        if specs is not None:
            raw = _collect_readback(payload[0])
            _phase("readback_wait", t0)
            res = _unpack_host(raw, specs)
        else:
            res = tuple(_collect_readback(ch) for ch in payload)
            _phase("readback_wait", t0)
        submit_store(key, bounds, res)

    def host_block(r0, r1, c0, c1):
        """Overlapped read window, clipped to the raster, padded to the
        uniform (ts + 2 ov) shape so jit reuses one compilation; edge
        replication preserves local stencils."""
        rr0, cc0 = max(r0 - ov, 0), max(c0 - ov, 0)
        rr1, cc1 = min(r1 + ov, H), min(c1 + ov, W)
        # np.asarray materializes lazy sources; dtype is preserved
        block = np.asarray(Z[rr0:rr1, cc0:cc1])
        ph = (ov - (r0 - rr0), ov - (rr1 - r1))
        pw = (ov - (c0 - cc0), ov - (cc1 - c1))
        fh = ts - (r1 - r0)
        fw = ts - (c1 - c0)
        return np.pad(block, ((ph[0], ph[1] + fh),
                              (pw[0], pw[1] + fw)), mode="edge")

    t_total = _time.perf_counter()

    if mesh_wire_fn is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as JP
        D = int(np.prod([v for v in mesh.shape.values()]))
        axis = tuple(mesh.shape.keys())[0]
        sharding = NamedSharding(mesh, JP(axis))
        if multi is None:
            multi = True

        def flush_group():
            keys, bounds_list, shard_datas = inflight.popleft()
            for key, bounds, sd in zip(keys, bounds_list, shard_datas):
                # each shard is (1, ts, n_bytes): one tile's packed
                # wire buffer with its leading shard axis.  Only the
                # blocking device->host copy counts as readback_wait —
                # unpack is host work and submit_store's backpressure
                # is already accounted as store_wait (timing the whole
                # loop would double-count it into readback_wait and
                # point the documented diagnosis at the wire when the
                # writer thread is the bottleneck)
                t0 = _time.perf_counter()
                buf = np.asarray(sd)[0]
                _phase("readback_wait", t0)
                submit_store(key, bounds, _unpack_host(buf, wire_specs))

        def dispatch_group(keys, bounds_list, blocks):
            # pad a final partial group by repeating its last tile —
            # the duplicate shards are simply never read back
            n_real = len(keys)
            while len(blocks) < D:
                blocks.append(blocks[-1])
            t0 = _time.perf_counter()
            stacked = jax.device_put(np.stack(blocks), sharding)
            _phase("upload", t0)
            t0 = _time.perf_counter()
            wirebuf = mesh_wire_fn(stacked)
            shards = sorted(wirebuf.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            datas = [s.data for s in shards[:n_real]]
            for d in datas:
                _start_host_copy(d)
            _phase("dispatch", t0)
            inflight.append((keys, bounds_list, datas))
            while len(inflight) > max(int(pipeline_depth), 0):
                flush_group()

        g_keys, g_bounds, g_blocks = [], [], []
        for ty in range(n_ty):
            for tx in range(n_tx):
                key = (ty, tx)
                if ckpt and ckpt.is_done(key):
                    continue
                r0, c0 = ty * ts, tx * ts
                r1, c1 = min(r0 + ts, H), min(c0 + ts, W)
                g_keys.append(key)
                g_bounds.append((r0, r1, c0, c1))
                t0 = _time.perf_counter()
                g_blocks.append(host_block(r0, r1, c0, c1))
                _phase("host_read", t0)
                _ps["tiles"] = _ps.get("tiles", 0) + 1
                if len(g_keys) == D:
                    dispatch_group(g_keys, g_bounds, g_blocks)
                    g_keys, g_bounds, g_blocks = [], [], []
        if g_keys:
            dispatch_group(g_keys, g_bounds, g_blocks)
        while inflight:
            flush_group()
        drain_stores()
        _phase("total", t_total)
        if out is None:
            raise ValueError(
                "checkpoint marks every tile done but no `out` arrays "
                "were given to resume into — pass the previous outputs "
                "via `out=` or delete the checkpoint file to recompute")
        return out if multi else out[0]

    # Block acquisition (source window read + pad + device upload) can
    # run on a PREFETCH THREAD feeding a bounded queue
    # (``prefetch=True``), letting uploads duplex with the readbacks
    # the dispatch thread blocks on.  On a single-vCPU host the GIL
    # makes this a wash-to-loss for CPU-bound phases, so it is an
    # opt-in measured per deployment; the inline path (default) is the
    # r3-tuned single-threaded loop.  Bounded queue depth keeps at
    # most 2 acquired-but-undispatched blocks alive (HBM: 2 blocks +
    # pipeline_depth wire buffers).
    import queue as _queuemod
    import threading

    work = [(ty, tx) for ty in range(n_ty) for tx in range(n_tx)
            if not (ckpt and ckpt.is_done((ty, tx)))]
    _ps["tiles"] = _ps.get("tiles", 0) + len(work)
    q = _queuemod.Queue(maxsize=2)
    stop = threading.Event()

    def _acquire(key):
        ty, tx = key
        r0, c0 = ty * ts, tx * ts
        r1, c1 = min(r0 + ts, H), min(c0 + ts, W)
        if device_input:
            t0 = _time.perf_counter()
            block = _device_block(r0, c0)
            _phase("upload", t0)
        else:
            t0 = _time.perf_counter()
            block = host_block(r0, r1, c0, c1)
            _phase("host_read", t0)
        if wire_fn is not None and not _is_device_array(block):
            t0 = _time.perf_counter()
            block = _banded_put(np.asarray(block), dev_state)
            _phase("upload", t0)
        return (key, (r0, r1, c0, c1), block)

    def _producer():
        try:
            for key in work:
                if stop.is_set():
                    return
                q.put(_acquire(key))
            q.put(None)
        except BaseException as e:  # surfaced on the dispatch thread
            q.put(("__error__", e))

    def _process(item):
        key, bounds, block = item
        nonlocal multi
        if wire_fn is not None:
            t0 = _time.perf_counter()
            chunks = list(wire_fn(block))
            for c in chunks:
                _start_host_copy(c)
            _phase("dispatch", t0)
            if multi is None:
                multi = True
            payload, specs = [chunks], wire_specs
        else:
            t0 = _time.perf_counter()
            res = fn(block)
            if multi is None:
                multi = isinstance(res, (tuple, list))
            res = res if isinstance(res, (tuple, list)) else (res,)
            # crop the overlap ON DEVICE so only the tile core
            # crosses the wire (edge tiles keep their uniform
            # ts x ts shape here; the valid sub-rectangle is cut
            # on the host)
            res = tuple(a[ov:ov + ts, ov:ov + ts] for a in res)
            specs = None
            if len(res) > 1 and all(_is_device_array(a) for a in res):
                packed, specs = _pack_device(res)
                payload = [_stage_readback(packed)]
            else:
                payload = [_stage_readback(a) for a in res]
            _phase("dispatch", t0)
        inflight.append((key, bounds, payload, specs))
        while len(inflight) > max(int(pipeline_depth), 0):
            flush_one()

    if prefetch:
        prod = threading.Thread(target=_producer, daemon=True)
        prod.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if item[0] == "__error__":
                    raise item[1]
                _process(item)
            while inflight:
                flush_one()
            drain_stores()
        finally:
            stop.set()
            while prod.is_alive():  # unblock a q.put on backpressure
                try:
                    q.get_nowait()
                except _queuemod.Empty:
                    pass
                prod.join(timeout=0.1)
    else:
        for key in work:
            _process(_acquire(key))
        while inflight:
            flush_one()
        drain_stores()
    _phase("total", t_total)
    if out is None:
        raise ValueError(
            "checkpoint marks every tile done but no `out` arrays were "
            "given to resume into — pass the previous outputs via "
            "`out=` or delete the checkpoint file to recompute")
    return out if multi else out[0]


def apply_parallel(function, array, chunks=None, depth=0,
                   extra_arguments=(), extra_keywords=None):
    """Drop-in for ``skimage.util.apply_parallel(function, array,
    chunks, depth)`` as the reference notebooks use it
    (test_neilpy.py:45, 92): overlapping-tile map with the overlap
    cropped.  Backed by ``tiled_apply``, so every tile runs the same
    compiled kernel on the accelerator; pass ``chunks=None`` to run
    the function on the whole array.

    Exactness contract (same CLASS as skimage's): with ``depth`` >=
    the stencil radius, every pixel farther than ``depth`` from the
    GLOBAL raster edge equals the untiled result; inside that border
    band the tile kernel sees padding instead of the true edge
    (edge-replicate here; skimage's default depth padding is reflect,
    so the two disagree only inside that band).  For bit-exact
    boundaries use ``dist.sharded_apply`` / the sharded kernels, which
    carry the global origin."""
    if extra_keywords is None:
        extra_keywords = {}
    fn = lambda Z: function(Z, *extra_arguments, **extra_keywords)
    if chunks is None:
        return np.asarray(fn(np.asarray(array)))
    if isinstance(chunks, (tuple, list)):
        if len(set(int(c) for c in chunks)) != 1:
            raise ValueError(
                "apply_parallel here supports square tiles only; got "
                f"chunks={chunks} (pass a scalar or equal per-dim "
                "chunks)")
        chunks = int(chunks[0])
    return tiled_apply(fn, array, int(chunks), int(depth))
