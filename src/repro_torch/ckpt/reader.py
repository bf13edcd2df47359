"""Checkpoint restore with cross-mesh resharding.

``restore`` reads a checkpoint written under *any* topology and materializes
it under *any* target sharding, reading only the chunks that overlap each
local shard. This is the mechanism behind the paper's cross-cloud migration
(§5.3/§7.3): the image format is topology-agnostic, so "migrating" a job to
a differently-shaped cluster is just a restore under new shardings.

The read path is a prefetching parallel plane (plane.DataPlaneConfig):
restore first walks every leaf's target regions to enumerate the chunks it
will need, fans the fetch+decode of those chunks out across
``fetch_workers`` threads (bounded by ``max_inflight_bytes``), then
assembles shards in deterministic manifest order from the results. A
single-flight cache keyed by (store key, dtype, shape) guarantees a chunk
shared by many shards — or many leaves, as after resharding — is fetched
exactly once per distinct decode no matter how many workers race for it,
and each decoded chunk is evicted right after its last assembly use. With
``fetch_workers=1`` fetches happen inline, serially, in assembly order.

Port of ``repro/ckpt/reader.py``. A leaf is assembled whole on the host
and placed on the requested torch device; sharded restore is a later
slice. One addition: a float leaf of an int8 image (``QS01INT8``) whose
one chunk covers it is decoded where it lands. Its chunk goes through the
same source as every other (prefetch budget, single-flight cache,
``restore/fetch_decode`` span), which hands back the unframed int8 codes
and scales; they cross to the device and ``kernels.qsnap.qsnap_dequantize``
(the CUDA kernel on a card, its plain version on the CPU) rebuilds the
values, bit for bit what the host decoder gives. The swap-in copy then
carries the same ~4x fewer bytes as the swap-out copy. A caller that
assembles regions on the host (``_assemble_region``: the gang restore)
gets such a chunk dequantized on the host, as the reference does.
"""
from __future__ import annotations

import concurrent.futures as cf
import re
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import compression
from repro_torch.ckpt.layout import (COMMITTED, MANIFEST, LeafInfo, Manifest,
                                     build_from_skeleton, cas_key,
                                     chunk_digest, leaf_items, np_dtype,
                                     step_prefix, to_tensor)
from repro_torch.device import resolve_device
from repro_torch.ckpt.plane import DataPlaneConfig, shared_executor
from repro_torch.ckpt.storage import ObjectStore
from repro_torch.obs.trace import tracer

_STEP_RE = re.compile(r"step_(\d+)/COMMITTED$")


def list_steps(store: ObjectStore, prefix: str) -> List[int]:
    steps = []
    for key in store.list(prefix):
        m = _STEP_RE.search(key)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(store: ObjectStore, prefix: str) -> Optional[int]:
    steps = list_steps(store, prefix)
    return steps[-1] if steps else None


def load_manifest(store: ObjectStore, prefix: str, step: int) -> Manifest:
    sp = step_prefix(prefix, step)
    if not store.exists(f"{sp}/{COMMITTED}"):
        raise FileNotFoundError(f"step {step} not committed under {prefix}")
    return Manifest.from_json(store.get(f"{sp}/{MANIFEST}").decode())


# ---------------------------------------------------------------------------
# Chunk assembly
# ---------------------------------------------------------------------------

def _overlap(dst_off: Tuple[int, ...], dst_shape: Tuple[int, ...],
             src_off: Tuple[int, ...], src_shape: Tuple[int, ...]
             ) -> Optional[Tuple[Tuple[slice, ...], Tuple[slice, ...]]]:
    """Slices (into dst, into src) of the overlapping region, or None."""
    dst_sl, src_sl = [], []
    for do, ds, so, ss in zip(dst_off, dst_shape, src_off, src_shape):
        lo = max(do, so)
        hi = min(do + ds, so + ss)
        if hi <= lo:
            return None
        dst_sl.append(slice(lo - do, hi - do))
        src_sl.append(slice(lo - so, hi - so))
    return tuple(dst_sl), tuple(src_sl)


def _read_chunk(store: ObjectStore, li: LeafInfo, chunk, codec: str,
                prefix: Optional[str] = None) -> np.ndarray:
    """Fetch + decode one chunk, resolving by content hash when possible."""
    data = _fetch_chunk(store, li, chunk, prefix)
    raw = compression.decode(data, li.dtype, codec)
    return np.frombuffer(raw, dtype=np_dtype(li.dtype)).reshape(chunk.shape)


def _fetch_chunk(store: ObjectStore, li: LeafInfo, chunk,
                 prefix: Optional[str] = None) -> bytes:
    """Fetch one chunk's encoded bytes, verified against its digest.

    v2 chunks carry a digest: if the manifest's key is missing (e.g. an
    image cloned under a different prefix) the chunk is re-resolved from
    the local CAS namespace, and fetched bytes are verified against the
    digest before decode — end-to-end integrity on the restore path.
    """
    key = chunk.key
    try:
        data = store.get(key)
    except (KeyError, FileNotFoundError):
        if not (chunk.hash and prefix is not None):
            raise
        key = cas_key(prefix, chunk.hash)
        data = store.get(key)
    if chunk.hash is not None and chunk_digest(data) != chunk.hash:
        raise ValueError(
            f"leaf {li.name}: chunk {key} content digest mismatch "
            f"(corrupt object or hash collision)")
    return data


class _ChunkSource:
    """Single-flight fetch+decode cache shared by every leaf of one restore.

    ``register`` (planning pass) counts one future assembly use of a chunk
    and queues its fetch; fetches are admitted onto the worker pool while
    under ``max_inflight_bytes`` of encoded bytes (prefetch window — the
    read-path analogue of the writer's ByteBudget, so restoring an image
    near host-RAM size cannot buffer every decoded chunk at once).
    ``get`` blocks for the result, force-submitting on demand if assembly
    runs ahead of the window (which makes the budget deadlock-free);
    ``release`` drops the decoded array after its last registered use and
    admits the next queued fetch.

    The cache key is (store key, dtype, shape, decoded on the device): the
    CAS key alone is not enough — two leaves with byte-identical encoded chunks but different
    shape or dtype share a store key while decoding differently. A chunk
    reused across shards or leaves (common after resharding) is still
    fetched exactly once per distinct decode. Without a pool
    (fetch_workers<=1) fetches run inline at first ``get`` — serial
    behavior, same cache and eviction.

    A chunk of a leaf the card decodes (``_device_decodable``) is fetched,
    verified and unframed here like any other, but ``get`` gives its
    ``QS01INT8`` parts (n, scales, codes) instead of decoded values: the
    dequantize runs on the device at assembly.
    """

    def __init__(self, store: ObjectStore, codec: str,
                 prefix: Optional[str], pool: Optional[cf.Executor],
                 max_inflight_bytes: int = 0, trace_id: str = ""):
        self._store = store
        self._codec = codec
        self._prefix = prefix
        self._pool = pool
        # per-chunk spans on pool threads parent explicitly on the restore
        # root span open on the constructing thread
        self._trace_id = trace_id
        self._span = tracer().current()
        self._budget = max_inflight_bytes
        self._lock = threading.Lock()
        self._futs: Dict[tuple, cf.Future] = {}
        self._cache: Dict[tuple, np.ndarray] = {}
        self._uses: Dict[tuple, int] = {}
        self._queue: List[tuple] = []        # (ckey, li, chunk) to submit
        self._queued: set = set()
        self._inflight = 0                   # encoded bytes admitted

    @property
    def codec(self) -> str:
        return self._codec

    def _ckey(self, li: LeafInfo, chunk) -> tuple:
        return (chunk.key, li.dtype, tuple(chunk.shape),
                _device_decodable(li, self._codec))

    def register(self, li: LeafInfo, chunk) -> None:
        ck = self._ckey(li, chunk)
        with self._lock:
            self._uses[ck] = self._uses.get(ck, 0) + 1
            if self._pool is not None and ck not in self._queued:
                self._queued.add(ck)
                self._queue.append((ck, li, chunk))
        self._pump()

    def _read_traced(self, li: LeafInfo, chunk) -> Any:
        read = (_read_int8 if _device_decodable(li, self._codec)
                else _read_chunk)
        with tracer().span("restore/fetch_decode", cat="ckpt",
                           trace_id=self._trace_id, parent=self._span,
                           args={"leaf": li.name}):
            return read(self._store, li, chunk, self._codec, self._prefix)

    def _submit_locked(self, ck, li, chunk) -> cf.Future:
        self._inflight += max(1, chunk.nbytes)
        fut = self._pool.submit(self._read_traced, li, chunk)
        self._futs[ck] = fut
        return fut

    def _pump(self) -> None:
        if self._pool is None:
            return
        with self._lock:
            while self._queue and (self._budget <= 0 or self._inflight == 0
                                   or self._inflight < self._budget):
                ck, li, chunk = self._queue.pop(0)
                # skip stale entries: already admitted (force-submitted by
                # get() overtaking the window) or fully released — a
                # resubmit would double-fetch and leak _inflight forever
                if ck in self._uses and ck not in self._futs \
                        and ck not in self._cache:
                    self._submit_locked(ck, li, chunk)

    def get(self, li: LeafInfo, chunk) -> Any:
        ck = self._ckey(li, chunk)
        with self._lock:
            fut = self._futs.get(ck)
            if fut is None:
                if ck in self._cache:
                    return self._cache[ck]
                if self._pool is not None:   # ahead of the prefetch window
                    fut = self._submit_locked(ck, li, chunk)
        if fut is not None:
            return fut.result()
        arr = self._read_traced(li, chunk)
        with self._lock:
            self._cache[ck] = arr
        return arr

    def release(self, li: LeafInfo, chunk) -> None:
        """Called once per registered use; evicts after the last one."""
        ck = self._ckey(li, chunk)
        with self._lock:
            left = self._uses.get(ck, 0) - 1
            if left > 0:
                self._uses[ck] = left
                return
            self._uses.pop(ck, None)
            if self._futs.pop(ck, None) is not None:
                self._inflight -= max(1, chunk.nbytes)
            self._cache.pop(ck, None)
        self._pump()

    def cancel_pending(self) -> None:
        """Best-effort cancel of queued fetches (aborted restore); fetches
        already running on the shared pool finish and are discarded."""
        with self._lock:
            self._queue.clear()
            for fut in self._futs.values():
                fut.cancel()


def _chunk_values(source: _ChunkSource, li: LeafInfo, chunk) -> np.ndarray:
    """One chunk's decoded values on the host. A chunk the card would
    decode comes from the source as its ``QS01INT8`` parts; they are
    dequantized here, as ``compression.decode`` does, so any region of
    any leaf assembles on the host."""
    got = source.get(li, chunk)
    if not _device_decodable(li, source.codec):
        return got
    n, scales, codes = got
    vals = compression.dequantize_int8(codes, scales, n)
    if compression.is_bf16(li.dtype):
        vals = compression.f32_to_bf16_bits(vals)
    return vals.view(np_dtype(li.dtype)).reshape(chunk.shape)


def _assemble_region(source: _ChunkSource, li: LeafInfo,
                     offset: Tuple[int, ...], shape: Tuple[int, ...]
                     ) -> np.ndarray:
    """Materialize leaf[offset : offset+shape] from overlapping chunks."""
    out = np.zeros(shape, dtype=np_dtype(li.dtype))
    covered = 0
    for chunk in li.chunks:
        ov = _overlap(offset, shape, chunk.offset, chunk.shape)
        if ov is None:
            continue
        dst_sl, src_sl = ov
        out[dst_sl] = _chunk_values(source, li, chunk)[src_sl]
        source.release(li, chunk)            # evicted after its last use
        covered += int(np.prod([s.stop - s.start for s in dst_sl])) \
            if shape else 1
    want = int(np.prod(shape)) if shape else 1
    if covered != want:
        raise ValueError(
            f"leaf {li.name}: region {offset}+{shape} only {covered}/{want} "
            f"elements covered by checkpoint chunks (corrupt or partial image)")
    return out


def _leaf_regions(li: LeafInfo) -> List[Tuple[Optional[Any], Tuple[int, ...],
                                             Tuple[int, ...]]]:
    """Target regions [(None, offset, shape)] this process needs: the whole
    leaf (sharded targets are a later slice of the port)."""
    shape = tuple(li.shape)
    return [(None, (0,) * len(shape), shape)]


_DEVICE_DECODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _device_decodable(li: LeafInfo, codec: str) -> bool:
    """A float leaf of an int8 image stored as one chunk covering it."""
    return (codec in ("int8", "int8+zlib") and li.kind == "array"
            and li.dtype in _DEVICE_DECODE_DTYPES and len(li.chunks) == 1
            and tuple(li.chunks[0].shape) == tuple(li.shape)
            and not any(li.chunks[0].offset))


def _upload(a: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Host array -> ``device``, through a pinned buffer on a card."""
    t = torch.empty(a.shape, dtype=dtype, pin_memory=device.type == "cuda")
    t.numpy()[...] = a
    return t.to(device, non_blocking=True)


def _read_int8(store: ObjectStore, li: LeafInfo, chunk, codec: str,
               prefix: Optional[str] = None
               ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Fetch one chunk of a leaf the card decodes -> its ``QS01INT8`` parts
    (n, scales f32, codes int8)."""
    data = _fetch_chunk(store, li, chunk, prefix)
    if codec == "int8+zlib":
        data = zlib.decompress(data)
    if data[:8] != b"QS01INT8":
        raise ValueError(f"leaf {li.name}: corrupt int8 chunk")
    return compression.parse_int8(data)


def _decode_on_device(source: _ChunkSource, li: LeafInfo,
                      device: torch.device) -> torch.Tensor:
    """The leaf's one int8 chunk -> leaf tensor on ``device``: the codes
    and scales cross, and ``qsnap_dequantize`` rebuilds the values."""
    from repro_torch.kernels.qsnap import qsnap_dequantize
    chunk = li.chunks[0]
    n, scales, codes = source.get(li, chunk)
    with tracer().span("restore/device_decode", cat="ckpt",
                       args={"leaf": li.name}):
        codes_d = _upload(codes, torch.int8, device)
        scales_d = _upload(scales, torch.float32, device)
        source.release(li, chunk)            # staged in pinned buffers
        out = qsnap_dequantize(codes_d, scales_d,
                               _DEVICE_DECODE_DTYPES[li.dtype])
    return out[:n].view(tuple(li.shape))


def _restore_leaf(source: _ChunkSource, li: LeafInfo, regions,
                  device: torch.device, dtype_override=None) -> Any:
    if li.kind == "scalar":
        arr = _assemble_region(source, li, *regions[0][1:])
        return arr.item() if arr.ndim == 0 else arr
    if _device_decodable(li, source.codec):
        out = _decode_on_device(source, li, device)
    else:
        full = _assemble_region(source, li, *regions[0][1:])
        out = to_tensor(full, li.dtype, device)
    return out if dtype_override is None else out.to(dtype_override)


def restore(store: ObjectStore, prefix: str, step: Optional[int] = None, *,
            target: Any = None,
            plane: Optional[DataPlaneConfig] = None,
            trace_id: str = "",
            device: Any = None,
            ) -> Tuple[Any, Manifest]:
    """Restore a checkpoint onto one torch device.

    target:    optional pytree (of tensors) fixing leaf dtypes; None = the
               stored dtypes, structure rebuilt from the manifest skeleton.
    plane:     parallel data-plane knobs; fetch_workers concurrent chunk
               fetch+decodes (None = DataPlaneConfig()).
    trace_id:  correlates the emitted restore spans with the owning job.
    device:    where array leaves land: ``cuda`` unless ``"cpu"`` is asked
               for; with no GPU and no explicit request this raises.
    """
    device = resolve_device(device)
    if step is None:
        step = latest_step(store, prefix)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {prefix}")
    with tracer().span("ckpt/restore", cat="ckpt", trace_id=trace_id,
                       args={"step": step}):
        manifest = load_manifest(store, prefix, step)
        plane = plane or DataPlaneConfig()

        dtype_by_name: Dict[str, Any] = {}
        if target is not None:
            for name, leaf in leaf_items(target):
                if hasattr(leaf, "dtype"):
                    dtype_by_name[name] = leaf.dtype

        pool = None
        if plane.fetch_workers > 1:
            pool = shared_executor("fetch", plane.fetch_workers)
        source = _ChunkSource(store, manifest.codec, prefix, pool,
                              plane.max_inflight_bytes, trace_id=trace_id)
        try:
            # plan all leaves first, registering every (region, chunk) use
            # so the source can prefetch each distinct decode exactly once
            # and evict it after its last assembly …
            plans: Dict[str, tuple] = {}
            with tracer().span("restore/plan", cat="ckpt"):
                for name, li in manifest.leaves.items():
                    regions = _leaf_regions(li)
                    plans[name] = regions
                    for chunk in li.chunks:
                        for _, off, shp in regions:
                            if _overlap(off, shp, chunk.offset, chunk.shape):
                                source.register(li, chunk)
            # … then assemble in deterministic manifest order
            leaves: Dict[str, Any] = {}
            with tracer().span("restore/assemble", cat="ckpt"):
                for name, li in manifest.leaves.items():
                    leaves[name] = _restore_leaf(
                        source, li, plans[name], device,
                        dtype_by_name.get(name))
        except BaseException:
            source.cancel_pending()  # don't leave queued fetches running
            raise
        tree = build_from_skeleton(manifest.skeleton, leaves)
        return tree, manifest
