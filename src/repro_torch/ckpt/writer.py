"""Async sharded checkpoint writer with atomic commit + incremental dedup.

Protocol (crash-safe at every point):
  1. every host serializes + puts its *local* shards (parallel data plane);
  2. the coordinator puts the manifest (global offsets only);
  3. the store is flushed (two-tier: remote replication durable);
  4. the coordinator puts the COMMITTED marker.
A reader only trusts steps with a COMMITTED marker, so partially-written
checkpoints are invisible. The async writer stages device->host copies
synchronously (consistent snapshot at a step boundary — the JAX analogue of
DMTCP's coordinated checkpoint) and does encode+upload off the critical path
(paper §5.2's lazy local->remote copy).

Incremental saves (format v2, the default): each encoded chunk is stored
under its content digest in a shared ``<prefix>/cas/`` namespace
(layout.cas_key). Before putting, the writer consults the previous committed
manifest — any chunk whose digest is already stored is skipped, so a save
after a step that only touched a subset of leaves/shards uploads only the
delta. This attacks the paper's dominant cost driver (image size / write
time, Table 2 + Fig 6) from a different axis than the codecs: codecs shrink
every chunk, dedup removes *unchanged* chunks entirely. ``AsyncCheckpointer``
additionally keeps a per-leaf raw-content hash cache so unchanged chunks skip
even the encode step, not just the upload.

Parallel data plane (plane.py): chunks flow through a bounded encode pool
into a concurrent upload stage — ``DataPlaneConfig`` sets the worker counts
and the in-flight byte cap (backpressure). Dedup tables (``known``,
``raw_cache``) are shared across workers under one lock, and single-flight
claims per digest guarantee the same puts / counters / bytes as the serial
plane regardless of scheduling; with ``workers=1`` the plane degenerates to
exactly the serial loop. The commit protocol is untouched: every upload is
joined before the manifest is put, so steps 2–4 above still gate visibility.
"""
from __future__ import annotations

import concurrent.futures as cf
import hashlib
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.ckpt import compression
from repro_torch.ckpt.layout import (COMMITTED, MANIFEST, ChunkInfo,
                                     LeafInfo, Manifest, PreEncodedLeaf,
                                     cas_key, chunk_digest, chunk_key,
                                     dtype_name, leaf_items, local_shards,
                                     step_prefix, structure_skeleton)
from repro_torch.ckpt.plane import (ByteBudget, DataPlaneConfig, PreEncodedChunk,
                              SingleFlight, shared_executor)
from repro_torch.ckpt.snapshot import SnapshotHandle, resolve_state
from repro_torch.ckpt.storage import ObjectStore
from repro_torch.obs.telemetry import registry
from repro_torch.obs.trace import tracer


def _stage(tree: Any, rank: Optional[int] = None
           ) -> List[Tuple[str, str, Tuple[int, ...], str,
                           List[Tuple[Tuple[int, ...], Tuple[int, ...],
                                      np.ndarray]]]]:
    """Synchronous device->host staging: [(name, kind, shape, dtype, shards)].

    ``PreEncodedLeaf`` leaves (device-side encode already done) carry
    ``PreEncodedChunk`` payloads in the shard slot instead of host
    ndarrays; the encode stage passes them through untouched. Tensor
    leaves are copied to the host whole (bf16 as int16 words; the leaf's
    dtype name stays "bfloat16"). In a sharded save (``rank`` given) a
    DTensor leaf stages this rank's unique shards (``local_shards``) under
    its global shape, and every other leaf is staged by rank 0 alone;
    without a rank a DTensor leaf is refused.
    """
    staged = []
    for name, leaf in leaf_items(tree):
        if isinstance(leaf, PreEncodedLeaf):
            staged.append((name, leaf.kind, tuple(leaf.shape), leaf.dtype,
                           [] if rank else list(leaf.chunks)))
            continue
        kind = ("array" if isinstance(leaf, (torch.Tensor, np.ndarray))
                else "scalar")
        if isinstance(leaf, DTensor):
            if rank is None:
                raise ValueError(
                    f"leaf {name} is a DTensor: a sharded tree is saved by "
                    f"save_checkpoint on every rank of its mesh")
            shards = local_shards(leaf)
        else:
            shards = [] if rank else local_shards(leaf)
        if kind == "scalar":
            shape, dtype = np.asarray(leaf).shape, str(np.asarray(leaf).dtype)
        else:
            shape, dtype = tuple(leaf.shape), dtype_name(leaf.dtype)
        staged.append((name, kind, tuple(shape), dtype, shards))
    return staged


def _sharded_rank(tree: Any) -> Optional[int]:
    """This process's rank when ``tree`` holds DTensor leaves, else None."""
    if any(isinstance(leaf, DTensor) for _, leaf in leaf_items(tree)):
        return dist.get_rank()
    return None


def _raw_digest(codec: str, dtype: str, raw: bytes) -> str:
    """Identity of a chunk's *unencoded* content (pre-codec dedup key).

    Scoped by codec: the cache maps raw content to an *encoded* digest,
    so the same bytes saved under a different codec (e.g. a lossless
    periodic image vs an int8 swap-out image) must miss, not alias.
    """
    h = hashlib.blake2b(digest_size=20)
    h.update(codec.encode())
    h.update(b"\0")
    h.update(dtype.encode())
    h.update(raw)
    return h.hexdigest()


def _adapt_pre_encoded(chunk: PreEncodedChunk, codec: str) -> bytes:
    """Finish a device-encoded payload for the image codec.

    Equal codec: pass through (byte-identical to the host encoder, so the
    CAS digest dedups across device- and host-compressed images).
    ``int8+zlib`` over an ``int8`` payload: apply the same deflate the
    host codec would. Anything else is a policy error — lossy payloads
    cannot satisfy a lossless image codec.
    """
    if codec == chunk.codec:
        return chunk.data
    if codec == "int8+zlib" and chunk.codec == "int8":
        return zlib.compress(chunk.data, level=1)
    raise ValueError(
        f"pre-encoded chunk (codec {chunk.codec!r}) cannot satisfy "
        f"image codec {codec!r}")


def known_digests(store: ObjectStore, prefix: str,
                  before_step: Optional[int] = None) -> Dict[str, int]:
    """digest -> encoded nbytes for the newest committed manifest.

    This is the writer's dedup table: any chunk whose encoded digest appears
    here is guaranteed live in the store (GC always retains the most recent
    committed step), so its put can be skipped without an existence check.
    """
    from repro_torch.ckpt.reader import list_steps, load_manifest
    steps = [s for s in list_steps(store, prefix)
             if before_step is None or s < before_step]
    if not steps:
        return {}
    man = load_manifest(store, prefix, steps[-1])
    return {c.hash: c.nbytes for li in man.leaves.values()
            for c in li.chunks if c.hash is not None}


def save_checkpoint(store: ObjectStore, prefix: str, step: int, tree: Any, *,
                    codec: str = "raw", incremental: bool = True,
                    metadata: Optional[Dict[str, Any]] = None,
                    plane: Optional[DataPlaneConfig] = None,
                    trace_id: str = "") -> Manifest:
    """Blocking save. Returns the committed manifest.

    incremental=True (default) writes format-v2 content-addressed chunks and
    skips any chunk already present in the previous committed manifest;
    incremental=False writes the legacy step-private v1 layout.
    plane configures the parallel data plane (None = DataPlaneConfig()).
    ``tree`` may be a SnapshotHandle (resolved here — blocking save).
    trace_id correlates the emitted save spans with the owning job.

    A tree with DTensor leaves is saved collectively: every rank of the
    default process group calls this with its own tree (the same leaves
    and values, sharded over one mesh), and every rank gets the committed
    manifest back (``_write_sharded``).
    """
    with tracer().span("ckpt/save", cat="ckpt", trace_id=trace_id,
                       args={"step": step, "codec": codec,
                             "blocking": True}):
        with tracer().span("ckpt/materialize", cat="ckpt"):
            tree = resolve_state(tree)
            rank = _sharded_rank(tree)
            staged = _stage(tree, rank)
            skeleton = structure_skeleton(tree)
        write = _write_staged if rank is None else _write_sharded
        return write(store, prefix, step, staged, skeleton, codec,
                     metadata or {}, incremental=incremental, plane=plane,
                     trace_id=trace_id)


class _SaveContext:
    """Shared mutable state of one save: dedup tables, stats, backpressure.

    One lock guards ``known``, ``raw_cache`` and ``stats``; the two
    SingleFlight tables share it so a claim's existence check and the table
    lookup it guards are one atomic step.
    """

    def __init__(self, store: ObjectStore, prefix: str, codec: str,
                 incremental: bool, known: Optional[Dict[str, int]],
                 raw_cache: Optional[Dict[str, Tuple[str, int]]],
                 plane: DataPlaneConfig, cas_scope: str = "",
                 trace_id: str = ""):
        self.store = store
        self.prefix = prefix
        self.codec = codec
        # span context for per-chunk stages: pool threads cannot see the
        # caller's thread-local span stack, so they parent explicitly on
        # the save's root span captured here (None when untraced)
        self.trace_id = trace_id
        self.span = tracer().current()
        # CAS key namespace tag: chunks land at <prefix>/cas/<scope><digest>.
        # Gang saves scope each rank's uploads ("r<rank>-") so one rank's
        # puts are distinguishable — per-rank fault injection and per-rank
        # incremental dedup both key off it. "" = the classic shared space.
        self.cas_scope = cas_scope
        self.incremental = incremental
        self.known = known
        self.raw_cache = raw_cache
        self.lock = threading.Lock()
        self.raw_flight = SingleFlight(self.lock)
        self.put_flight = SingleFlight(self.lock)
        self.budget = ByteBudget(0 if plane.serial_save
                                 else plane.max_inflight_bytes, name="ckpt")
        self.stats = {"chunks": 0, "dedup_hits": 0, "dedup_misses": 0,
                      "bytes_written": 0, "bytes_deduped": 0}

    def count_hit(self, nbytes: int) -> None:
        with self.lock:
            self.stats["dedup_hits"] += 1
            self.stats["bytes_deduped"] += nbytes

    def count_miss(self, nbytes: int) -> None:
        with self.lock:
            self.stats["dedup_misses"] += 1
            self.stats["bytes_written"] += nbytes


class _Encoded:
    """Result of the encode stage for one chunk, handed to the upload stage.

    ``chunk`` is set when the encode stage fully resolved the chunk (raw
    cache hit — nothing to upload); otherwise ``data`` carries the encoded
    bytes and ``raw_key`` the raw-digest claim to settle after the put.
    """
    __slots__ = ("chunk", "key", "digest", "data", "raw_key", "off", "shp")

    def __init__(self, chunk=None, key=None, digest=None, data=None,
                 raw_key=None, off=None, shp=None):
        self.chunk = chunk
        self.key = key
        self.digest = digest
        self.data = data
        self.raw_key = raw_key
        self.off = off
        self.shp = shp


def _encode_chunk(ctx: _SaveContext, step: int, name: str, off, shp,
                  host, dtype: str) -> _Encoded:
    """Stage 1: serialize + codec + digest (CPU-bound, encode pool).

    ``host`` is a host ndarray, or a PreEncodedChunk whose payload was
    built on device — then the codec is already applied and this stage
    reduces to adapt + digest (the raw cache is skipped: there is no raw
    buffer, and no encode to save).
    """
    with tracer().span("ckpt/encode", cat="ckpt", trace_id=ctx.trace_id,
                       parent=ctx.span, args={"leaf": name}):
        return _encode_chunk_inner(ctx, step, name, off, shp, host, dtype)


def _encode_chunk_inner(ctx: _SaveContext, step: int, name: str, off, shp,
                        host, dtype: str) -> _Encoded:
    if isinstance(host, PreEncodedChunk):
        data = _adapt_pre_encoded(host, ctx.codec)
        if not ctx.incremental:
            return _Encoded(key=chunk_key(ctx.prefix, step, name, off),
                            data=data, off=off, shp=shp)
        return _Encoded(digest=chunk_digest(data), data=data, off=off,
                        shp=shp)
    raw = np.ascontiguousarray(host).tobytes()
    if not ctx.incremental:
        key = chunk_key(ctx.prefix, step, name, off)
        data = compression.encode(raw, dtype, ctx.codec)
        return _Encoded(key=key, data=data, off=off, shp=shp)
    rk: Optional[str] = None
    if ctx.raw_cache is not None:
        rk = _raw_digest(ctx.codec, dtype, raw)
        if not ctx.raw_flight.claim(rk, lambda: rk in ctx.raw_cache):
            with ctx.lock:
                digest, nbytes = ctx.raw_cache[rk]
            ctx.count_hit(nbytes)                # skipped encode AND put
            return _Encoded(chunk=ChunkInfo(
                off, shp, cas_key(ctx.prefix, ctx.cas_scope + digest),
                nbytes, digest))
    try:
        data = compression.encode(raw, dtype, ctx.codec)
    except BaseException:
        if rk is not None:
            ctx.raw_flight.abort(rk)             # let a waiter retry
        raise
    return _Encoded(digest=chunk_digest(data), data=data, raw_key=rk,
                    off=off, shp=shp)


def _upload_chunk(ctx: _SaveContext, enc: _Encoded) -> ChunkInfo:
    """Stage 2: dedup-aware store put (IO-bound, upload pool)."""
    with tracer().span("ckpt/upload", cat="ckpt", trace_id=ctx.trace_id,
                       parent=ctx.span, args={"nbytes": len(enc.data)}):
        return _upload_chunk_inner(ctx, enc)


def _upload_chunk_inner(ctx: _SaveContext, enc: _Encoded) -> ChunkInfo:
    if not ctx.incremental:                      # legacy v1: plain put
        ctx.store.put(enc.key, enc.data)
        ctx.count_miss(len(enc.data))
        return ChunkInfo(enc.off, enc.shp, enc.key, len(enc.data))
    digest, nbytes = enc.digest, len(enc.data)
    ok = False
    try:
        if ctx.put_flight.claim(digest, lambda: digest in ctx.known):
            try:
                wrote = ctx.store.put_if_absent(
                    cas_key(ctx.prefix, ctx.cas_scope + digest), enc.data)
            except BaseException:
                ctx.put_flight.abort(digest)     # a waiter may retry the put
                raise
            with ctx.lock:
                ctx.known[digest] = nbytes
            (ctx.count_miss if wrote else ctx.count_hit)(nbytes)
            ctx.put_flight.done(digest)
        else:                                    # previous manifest, or a
            ctx.count_hit(nbytes)                # concurrent worker, won
        ok = True
    finally:
        if enc.raw_key is not None:
            if ok:
                with ctx.lock:
                    ctx.raw_cache[enc.raw_key] = (digest, nbytes)
            ctx.raw_flight.done(enc.raw_key)
    return ChunkInfo(enc.off, enc.shp,
                     cas_key(ctx.prefix, ctx.cas_scope + digest),
                     nbytes, digest)


def _run_pipeline(ctx: _SaveContext, plane: DataPlaneConfig, step: int,
                  tasks: List[tuple]) -> None:
    """Encode pool -> upload pool, bounded by ctx.budget; joins everything.

    Each task is (slots, i, name, off, shp, host, dtype); the finished
    ChunkInfo lands in ``slots[i]`` so the manifest is assembled in
    deterministic (staging) order no matter which worker finishes when.
    """
    up = shared_executor("up", plane.upload_workers)
    enc = shared_executor("enc", plane.encode_workers)

    def upload_job(slots, i, enc_result, admitted):
        try:
            slots[i] = _upload_chunk(ctx, enc_result)
        finally:
            ctx.budget.release(admitted)

    def encode_job(task, admitted):
        slots, i, name, off, shp, host, dtype = task
        try:
            enc_result = _encode_chunk(ctx, step, name, off, shp,
                                       host, dtype)
            if enc_result.chunk is not None:         # resolved: no upload
                slots[i] = enc_result.chunk
                ctx.budget.release(admitted)
                return None
            return up.submit(upload_job, slots, i, enc_result, admitted)
        except BaseException:
            ctx.budget.release(admitted)
            raise

    encode_futs = []
    for task in tasks:
        admitted = task[5].nbytes
        ctx.budget.acquire(admitted)                 # backpressure
        encode_futs.append(enc.submit(encode_job, task, admitted))
    upload_futs = [f.result() for f in encode_futs]
    for f in upload_futs:
        if f is not None:
            f.result()                               # join: all puts durable


def upload_staged(ctx: _SaveContext, plane: DataPlaneConfig, step: int,
                  staged) -> Dict[str, LeafInfo]:
    """Encode + upload staged shards through the data plane; no commit.

    Returns the leaf table with every put durably joined. The caller owns
    the commit protocol — `_write_staged` commits immediately; the gang
    writer (ckpt/gang.py) runs one of these per rank and commits a single
    merged manifest only after *every* rank's uploads joined.
    """
    leaves: Dict[str, LeafInfo] = {}
    tasks: List[tuple] = []
    for name, kind, shape, dtype, shards in staged:
        slots: List[Optional[ChunkInfo]] = [None] * len(shards)
        leaves[name] = LeafInfo(name, shape, dtype, kind, slots)
        for i, (off, shp, host) in enumerate(shards):
            ctx.stats["chunks"] += 1
            tasks.append((slots, i, name, off, shp, host, dtype))
    if plane.serial_save:
        for slots, i, name, off, shp, host, dtype in tasks:
            enc = _encode_chunk(ctx, step, name, off, shp, host, dtype)
            slots[i] = enc.chunk if enc.chunk is not None \
                else _upload_chunk(ctx, enc)
    else:
        _run_pipeline(ctx, plane, step, tasks)
    return leaves


def _write_staged(store: ObjectStore, prefix: str, step: int, staged,
                  skeleton, codec: str, metadata: Dict[str, Any], *,
                  incremental: bool = True,
                  known: Optional[Dict[str, int]] = None,
                  raw_cache: Optional[Dict[str, Tuple[str, int]]] = None,
                  plane: Optional[DataPlaneConfig] = None,
                  trace_id: str = "") -> Manifest:
    """Serialize + upload staged shards, then atomically commit.

    known:     digest -> nbytes of chunks guaranteed live in the store
               (primed from the previous committed manifest when None).
    raw_cache: raw-content digest -> (encoded digest, nbytes); lets repeat
               content skip the codec entirely (AsyncCheckpointer only).
    plane:     parallel data-plane knobs (None = DataPlaneConfig()).
    """
    plane = plane or DataPlaneConfig()
    if incremental and known is None:
        known = known_digests(store, prefix, before_step=step)
    ctx = _SaveContext(store, prefix, codec, incremental, known, raw_cache,
                       plane, trace_id=trace_id)
    leaves = upload_staged(ctx, plane, step, staged)
    return _commit(ctx, step, leaves, skeleton, metadata, ctx.stats)


def _commit(ctx: _SaveContext, step: int, leaves: Dict[str, LeafInfo],
            skeleton, metadata: Dict[str, Any],
            stats: Dict[str, int]) -> Manifest:
    """Put the manifest of joined uploads, then the COMMITTED marker."""
    store, trace_id = ctx.store, ctx.trace_id
    manifest = Manifest(step=step, codec=ctx.codec, leaves=leaves,
                        skeleton=skeleton,
                        metadata={**metadata, "time": time.time(),
                                  "dedup": stats},
                        version=2 if ctx.incremental else 1)
    sp = step_prefix(ctx.prefix, step)
    tr = tracer()
    with tr.span("ckpt/manifest", cat="ckpt", trace_id=trace_id,
                 parent=ctx.span, args={"step": step}):
        store.put(f"{sp}/{MANIFEST}", manifest.to_json().encode())
    with tr.span("ckpt/commit", cat="ckpt", trace_id=trace_id,
                 parent=ctx.span, args={"step": step}):
        store.flush()                              # durable before commit
        store.put(f"{sp}/{COMMITTED}", b"1")
        store.flush()       # marker durable too: a host that loses its fast
    reg = registry()        # tier right after save still sees the commit
    if reg.enabled:
        for k, v in stats.items():
            reg.inc(f"ckpt.{k}", v)
        reg.inc("ckpt.saves")
    return manifest


def _write_sharded(store: ObjectStore, prefix: str, step: int, staged,
                   skeleton, codec: str, metadata: Dict[str, Any], *,
                   incremental: bool = True,
                   plane: Optional[DataPlaneConfig] = None,
                   trace_id: str = "") -> Manifest:
    """One save from every rank of the default process group.

    Each rank encodes and uploads its own staged shards. Rank 0 gathers
    every rank's chunk records and commits one manifest: a leaf keeps its
    global shape, with one chunk per unique shard at its global offset,
    listed in rank order, the order the reference's single-controller
    writer stages a jax.Array's addressable shards in. The manifest is
    then broadcast from rank 0, so no rank returns before the commit.
    """
    plane = plane or DataPlaneConfig()
    known = (known_digests(store, prefix, before_step=step)
             if incremental else None)
    ctx = _SaveContext(store, prefix, codec, incremental, known, None,
                       plane, trace_id=trace_id)
    leaves = upload_staged(ctx, plane, step, staged)
    rank = dist.get_rank()
    parts = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object((leaves, ctx.stats), parts, dst=0)
    out: List[Optional[Manifest]] = [None]
    if rank == 0:
        merged = {name: LeafInfo(name, li.shape, li.dtype, li.kind,
                                 [c for lv, _ in parts
                                  for c in lv[name].chunks])
                  for name, li in leaves.items()}
        stats = {k: sum(st[k] for _, st in parts) for k in ctx.stats}
        out[0] = _commit(ctx, step, merged, skeleton, metadata, stats)
    dist.broadcast_object_list(out, src=0)
    return out[0]


class AsyncCheckpointer:
    """Double-buffered async checkpointing.

    ``save()`` blocks only for the device->host copy; serialization, codec
    and store puts run on a background thread (which in turn drives the
    parallel data plane — see ``DataPlaneConfig``). At most one snapshot is
    in flight — a second ``save()`` first waits for the previous one (double
    buffering), bounding host memory at 2x model state.

    Incremental mode maintains two dedup caches across saves:
      * ``_known``     — encoded digest -> nbytes (skips the store put);
      * ``_raw_cache`` — raw digest -> (encoded digest, nbytes) (skips the
        codec too — the common case for frozen embeddings / untouched
        optimizer slots).
    Both are shared across the plane's workers (guarded by the save's lock)
    and pruned after every commit to exactly the chunks of the manifest
    just written: those are the only chunks mark-and-sweep GC (ckpt/gc.py)
    is guaranteed to retain, so a cache hit can never reference a swept key.
    """

    def __init__(self, store: ObjectStore, prefix: str, *,
                 codec: str = "raw", incremental: bool = True,
                 plane: Optional[DataPlaneConfig] = None,
                 trace_id: str = ""):
        self.store = store
        self.prefix = prefix
        self.codec = codec
        self.trace_id = trace_id
        self.incremental = incremental
        self.plane = plane or DataPlaneConfig()
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt")
        self._inflight: Optional[cf.Future] = None
        self._lock = threading.Lock()
        self.last_committed: Optional[int] = None
        self.save_count = 0
        self.staging_time = 0.0
        self._known: Optional[Dict[str, int]] = None
        self._raw_cache: Dict[str, Tuple[str, int]] = {}
        # cumulative dedup counters across saves (read via stats())
        self.dedup_hits = 0
        self.dedup_misses = 0
        self.bytes_written = 0
        self.bytes_deduped = 0
        self.last_error: Optional[BaseException] = None
        self.failed_saves = 0

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None,
             on_commit=None, codec: Optional[str] = None) -> None:
        """Submit an async save of ``tree`` (a pytree or SnapshotHandle).

        A materialized pytree is staged synchronously here (legacy
        contract: the caller's lock protects it only for this call). A
        SnapshotHandle is resolved *on the writer thread* — the caller
        returns in microseconds and the device→host copy (or device
        encode) overlaps whatever the app does next. ``codec`` overrides
        this checkpointer's default for just this save (e.g. the lossy
        swap-out codec for a suspend image).
        """
        # A previous save's failure (e.g. a transient storage fault) must
        # not poison this independent save: record it and move on. The
        # failed step has no COMMITTED marker, so it is simply invisible.
        self.wait(raise_error=False)
        t0 = time.monotonic()
        if isinstance(tree, SnapshotHandle):
            staged = skeleton = None               # resolved on writer thread
        else:
            with tracer().span("ckpt/stage", cat="ckpt",
                               trace_id=self.trace_id,
                               args={"step": step}):
                staged = _stage(tree)              # sync: consistent snapshot
                skeleton = structure_skeleton(tree)
        self.staging_time += time.monotonic() - t0
        save_codec = codec or self.codec

        def job():
            with tracer().span("ckpt/save", cat="ckpt",
                               trace_id=self.trace_id,
                               args={"step": step, "codec": save_codec,
                                     "blocking": False}):
                if staged is None:
                    with tracer().span("ckpt/materialize", cat="ckpt"):
                        state = tree.resolve()     # off the app's hot path
                        job_staged = _stage(state)
                        job_skeleton = structure_skeleton(state)
                else:
                    job_staged, job_skeleton = staged, skeleton
                if self.incremental and self._known is None:
                    self._known = known_digests(self.store, self.prefix,
                                                before_step=step)
                man = _write_staged(self.store, self.prefix, step,
                                    job_staged, job_skeleton, save_codec,
                                    metadata or {},
                                    incremental=self.incremental,
                                    known=self._known,
                                    raw_cache=self._raw_cache,
                                    plane=self.plane,
                                    trace_id=self.trace_id)
                self._absorb(man)
                with self._lock:
                    self.last_committed = step
                if on_commit is not None:
                    on_commit(step)
        with self._lock:
            self._inflight = self._pool.submit(job)
            self.save_count += 1

    def _absorb(self, man: Manifest) -> None:
        """Fold a committed manifest's dedup stats into the cumulative
        counters and prune caches to its (GC-protected) chunk set."""
        d = man.metadata.get("dedup", {})
        with self._lock:
            self.dedup_hits += d.get("dedup_hits", 0)
            self.dedup_misses += d.get("dedup_misses", 0)
            self.bytes_written += d.get("bytes_written", 0)
            self.bytes_deduped += d.get("bytes_deduped", 0)
        if not self.incremental:
            return
        live = {c.hash for li in man.leaves.values() for c in li.chunks}
        self._known = {h: n for h, n in (self._known or {}).items()
                       if h in live}
        self._raw_cache = {rk: v for rk, v in self._raw_cache.items()
                           if v[0] in live}

    def run_serialized(self, fn):
        """Run ``fn`` on the writer thread, after any in-flight save.

        Deletes/sweeps of this prefix must go through here: a sweep computes
        refcounts from *committed* manifests only, so racing an in-flight
        save could reap chunks the save has put but not yet committed.
        """
        fut = self._pool.submit(fn)
        return fut.result()

    def invalidate(self, keys) -> None:
        """Drop dedup-cache entries for deleted chunk keys (their digests).

        Call after sweeping chunks outside the writer's own commit cycle
        (e.g. CheckpointManager.delete_image); a stale hit would commit a
        manifest pointing at a reaped chunk.
        """
        digests = {k.rsplit("/", 1)[-1] for k in keys}
        if self._known:
            self._known = {h: n for h, n in self._known.items()
                           if h not in digests}
        self._raw_cache = {rk: v for rk, v in self._raw_cache.items()
                           if v[0] not in digests}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"save_count": self.save_count,
                    "dedup_hits": self.dedup_hits,
                    "dedup_misses": self.dedup_misses,
                    "bytes_written": self.bytes_written,
                    "bytes_deduped": self.bytes_deduped}

    def wait(self, raise_error: bool = True) -> None:
        """Block until the in-flight save (if any) finishes.

        A failed save is consumed exactly once: its exception is recorded
        in ``last_error``/``failed_saves`` and the in-flight slot cleared,
        so one transient fault does not re-raise forever. With
        ``raise_error=False`` the failure is recorded but swallowed (the
        recovery path wants the newest COMMITTED image, not the error)."""
        with self._lock:
            fut = self._inflight
        if fut is None:
            return
        try:
            fut.result()
        except BaseException as e:                 # noqa: BLE001
            with self._lock:
                self.last_error = e
                self.failed_saves += 1
                if self._inflight is fut:
                    self._inflight = None
            if raise_error:
                raise

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
