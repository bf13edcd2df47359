"""Gang checkpoint images: one atomic manifest for an N-rank job.

A *gang image* stores the globally-consistent cut of a multi-VM job that
the barrier protocol (core/gang.py) produced. It is deliberately a plain
format-v2 checkpoint — ONE ``MANIFEST.json`` + ONE ``COMMITTED`` marker
under the job's normal step directory — so every existing consumer
(``latest_step``, GC mark-and-sweep, image replication, warm-image checks)
handles gang images without knowing they are gangs:

  * each *sharded* leaf appears once with its GLOBAL shape; every rank's
    shard is a chunk stamped at its global offset (the reader's
    region-overlap assembly reshards to any rank count for free);
  * drained in-flight messages are *routed* leaves — a (K, C) row matrix
    whose ``col`` column is a global row index; restore re-routes each row
    to the rank owning that row under the NEW partition;
  * everything else is replicated (every rank receives a copy);
  * per-rank sub-manifests land at ``<step>/rank_<r>.json`` — the
    manifest-of-manifests that records exactly which chunks each rank
    contributed (debugging / per-rank audit; restore never needs them).

Rank uploads run through per-rank ``_SaveContext``s whose CAS keys carry a
``r<rank>-`` scope (writer.py): a fault injected on one rank's key prefix
hits only that rank, and per-rank dedup tables never assume another
rank's chunk exists. The commit marker is written only after EVERY rank's
puts durably joined — abort anywhere earlier leaves nothing but orphan
CAS chunks (reaped by the normal sweep) and the previous committed gang
image untouched.

Port of ``repro/ckpt/gang.py``. ``load_gang_ranks`` assembles on the
host and places array leaves on the ``device`` it is given, as
``ckpt.restore`` does.
"""
from __future__ import annotations

import concurrent.futures as cf
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ckpt.layout import (COMMITTED, MANIFEST, LeafInfo, Manifest,
                                     step_prefix, structure_skeleton,
                                     to_tensor)
from repro_torch.ckpt.plane import DataPlaneConfig, shared_executor
from repro_torch.ckpt.reader import (_ChunkSource, _assemble_region,
                                     _overlap, latest_step, load_manifest,
                                     list_steps)
from repro_torch.ckpt.storage import ObjectStore
from repro_torch.ckpt.writer import _SaveContext, upload_staged
from repro_torch.device import resolve_device
from repro_torch.sharding.specs import owner_of_row, rank_region

# CAS basename of a rank-scoped chunk: "r<rank>-<digest>".
_RANK_SCOPE_RE = re.compile(r"^r(\d+)-")


def rank_scope(rank: int) -> str:
    """The CAS namespace tag one rank's uploads carry."""
    return f"r{rank}-"


def rank_manifest_key(prefix: str, step: int, rank: int) -> str:
    return f"{step_prefix(prefix, step)}/rank_{rank}.json"


def scope_of_key(key: str) -> Tuple[Optional[int], str]:
    """(rank, digest) of a CAS key; rank is None for unscoped keys."""
    base = key.rsplit("/", 1)[-1]
    m = _RANK_SCOPE_RE.match(base)
    if m is None:
        return None, base
    return int(m.group(1)), base[m.end():]


def scoped_known_digests(store: ObjectStore, prefix: str,
                         before_step: Optional[int] = None
                         ) -> Dict[int, Dict[str, int]]:
    """Per-rank dedup tables {rank: {digest: nbytes}} from the newest
    committed manifest. A digest known under one rank's scope says nothing
    about another rank's key, so the tables are NEVER merged."""
    steps = [s for s in list_steps(store, prefix)
             if before_step is None or s < before_step]
    if not steps:
        return {}
    out: Dict[int, Dict[str, int]] = {}
    for li in load_manifest(store, prefix, steps[-1]).leaves.values():
        for c in li.chunks:
            if c.hash is None:
                continue
            rank, _ = scope_of_key(c.key)
            if rank is not None:
                out.setdefault(rank, {})[c.hash] = c.nbytes
    return out


def _stage_ranks(rank_trees: Sequence[Dict[str, Any]],
                 sharded: Dict[str, int],
                 routed: Dict[str, Dict[str, Any]]):
    """Split per-rank trees into per-rank writer-staged lists + the global
    leaf table (name -> (kind, global_shape, dtype)).

    Sharded leaves concatenate along their axis in rank order (offsets are
    cumulative — no assumption the split is even). Routed leaves
    concatenate rows. Everything else must be identical in type/shape
    across ranks and is uploaded once, by rank 0.
    """
    n = len(rank_trees)
    names = list(rank_trees[0].keys())
    for r, t in enumerate(rank_trees):
        if list(t.keys()) != names:
            raise ValueError(f"rank {r} leaf names {list(t.keys())} != "
                             f"rank 0 names {names}")
    staged: List[List[tuple]] = [[] for _ in range(n)]
    for name in names:
        if name in sharded:
            axis = sharded[name]
            parts = [np.asarray(rank_trees[r][name]) for r in range(n)]
            base = parts[0]
            for p in parts[1:]:
                if (p.ndim != base.ndim or p.dtype != base.dtype or any(
                        i != axis and p.shape[i] != base.shape[i]
                        for i in range(p.ndim))):
                    raise ValueError(f"sharded leaf {name}: incompatible "
                                     f"rank shards {p.shape} vs {base.shape}")
            dim = sum(p.shape[axis] for p in parts)
            gshape = tuple(dim if i == axis else d
                           for i, d in enumerate(base.shape))
            off = 0
            for r, p in enumerate(parts):
                offset = tuple(off if i == axis else 0
                               for i in range(p.ndim))
                if p.size:
                    staged[r].append((name, "array", gshape, str(p.dtype),
                                      [(offset, p.shape, p)]))
                off += p.shape[axis]
        elif name in routed:
            parts = [np.atleast_2d(np.asarray(rank_trees[r][name],
                                              dtype=np.float64))
                     if np.asarray(rank_trees[r][name]).size else
                     np.zeros((0, int(routed[name]["cols"])), np.float64)
                     for r in range(n)]
            cols = parts[0].shape[1] if parts[0].ndim == 2 else \
                int(routed[name]["cols"])
            gshape = (sum(p.shape[0] for p in parts), cols)
            off = 0
            for r, p in enumerate(parts):
                if p.size:
                    staged[r].append((name, "array", gshape, "float64",
                                      [((off, 0), p.shape, p)]))
                off += p.shape[0]
        else:
            v = rank_trees[0][name]
            host = np.asarray(v)
            kind = "array" if isinstance(v, np.ndarray) else "scalar"
            staged[0].append((name, kind, tuple(host.shape), str(host.dtype),
                              [((0,) * host.ndim, host.shape, host)]))
    return staged, names


def save_gang_image(store: ObjectStore, prefix: str, step: int,
                    rank_trees: Sequence[Dict[str, Any]], *,
                    sharded: Dict[str, int],
                    routed: Optional[Dict[str, Dict[str, Any]]] = None,
                    codec: str = "raw",
                    metadata: Optional[Dict[str, Any]] = None,
                    plane: Optional[DataPlaneConfig] = None,
                    knowns: Optional[List[Dict[str, int]]] = None
                    ) -> Manifest:
    """Upload every rank's shards, then atomically commit ONE gang image.

    rank_trees: per-rank {leaf name: array/scalar} snapshots (all ranks
                quiesced at the same cut — the barrier's job, not ours).
    sharded:    leaf name -> axis it is partitioned on across ranks.
    routed:     leaf name -> {"by": <sharded leaf>, "col": <column holding
                the global row index>, "cols": <row width>} for drained
                in-flight message matrices.
    knowns:     optional per-rank dedup tables (GangCheckpointer threads
                these across epochs); None primes from the previous
                committed manifest, per scope.

    Any rank upload failing (crash, injected store fault) raises WITHOUT
    writing MANIFEST/COMMITTED: the epoch aborts all-or-nothing and only
    orphan CAS chunks remain for the sweeper.
    """
    routed = routed or {}
    plane = plane or DataPlaneConfig()
    n = len(rank_trees)
    if knowns is None:
        prev = scoped_known_digests(store, prefix, before_step=step)
        knowns = [dict(prev.get(r, {})) for r in range(n)]
    staged, names = _stage_ranks(rank_trees, sharded, routed)
    ctxs = [_SaveContext(store, prefix, codec, True, knowns[r], None, plane,
                         cas_scope=rank_scope(r)) for r in range(n)]
    if plane.serial_save:
        rank_leaves = [upload_staged(ctxs[r], plane, step, staged[r])
                       for r in range(n)]
    else:
        pool = shared_executor("gangrank", 8)
        futs = [pool.submit(upload_staged, ctxs[r], plane, step, staged[r])
                for r in range(n)]
        cf.wait(futs)           # every rank settles before any raise: an
        rank_leaves = [f.result() for f in futs]   # abort must not race
                                                   # in-flight sibling puts
    # merge: one leaf table with global shapes, chunks in rank order
    merged: Dict[str, LeafInfo] = {}
    for name in names:
        chunks: List[Any] = []
        proto: Optional[LeafInfo] = None
        for leaves in rank_leaves:
            li = leaves.get(name)
            if li is not None:
                proto = proto or li
                chunks.extend(li.chunks)
        if proto is None:       # routed leaf with zero messages anywhere
            spec = routed[name]
            merged[name] = LeafInfo(name, (0, int(spec["cols"])), "float64",
                                    "array", [])
        else:
            merged[name] = LeafInfo(name, proto.shape, proto.dtype,
                                    proto.kind, chunks)
    dedup = {k: sum(c.stats[k] for c in ctxs)
             for k in ctxs[0].stats} if ctxs else {}
    gang_meta = {"ranks": n, "sharded": dict(sharded),
                 "routed": {k: dict(v) for k, v in routed.items()},
                 "epoch": step}
    manifest = Manifest(
        step=step, codec=codec, leaves=merged,
        skeleton=structure_skeleton({name: None for name in names}),
        metadata={**(metadata or {}), "time": time.time(), "dedup": dedup,
                  "gang": gang_meta})
    sp = step_prefix(prefix, step)
    for r, leaves in enumerate(rank_leaves):
        sub = Manifest(step=step, codec=codec, leaves=leaves,
                       skeleton=structure_skeleton(
                           {name: None for name in leaves}),
                       metadata={"gang_rank": r, "ranks": n})
        store.put(rank_manifest_key(prefix, step, r), sub.to_json().encode())
    store.put(f"{sp}/{MANIFEST}", manifest.to_json().encode())
    store.flush()                                  # durable before commit
    store.put(f"{sp}/{COMMITTED}", b"1")
    store.flush()
    return manifest


def is_gang_manifest(manifest: Manifest) -> bool:
    return bool(manifest.metadata.get("gang"))


class _CountingStore:
    """Thin ``get``-counting wrapper proving each shared chunk is fetched
    exactly once by the single-flight restore source (acceptance metric for
    shrink-restore). Everything else delegates to the wrapped store."""

    def __init__(self, inner: ObjectStore):
        self._inner = inner
        self._lock = threading.Lock()
        self.fetches: Dict[str, int] = {}
        self.bytes_fetched = 0

    def get(self, key: str) -> bytes:
        data = self._inner.get(key)
        with self._lock:
            self.fetches[key] = self.fetches.get(key, 0) + 1
            self.bytes_fetched += len(data)
        return data

    def __getattr__(self, name):
        return getattr(self._inner, name)


def load_gang_ranks(store: ObjectStore, prefix: str,
                    step: Optional[int] = None,
                    n_ranks: Optional[int] = None, *,
                    plane: Optional[DataPlaneConfig] = None,
                    device: Any = None
                    ) -> Tuple[List[Dict[str, Any]], Manifest,
                               Dict[str, int]]:
    """Restore a gang image resharded onto ``n_ranks`` ranks.

    ``n_ranks`` may differ from the save-time gang size (elastic shrink /
    grow): sharded leaves are re-split by ``even_regions`` for the new
    count, routed message rows are re-routed to the rank now owning their
    target row, replicated leaves go to everyone. Returns
    ``(per-rank trees, manifest, fetch stats)`` where the stats prove the
    dedup claim: ``chunk_fetches == unique_chunks`` means no chunk shared
    between old and new shard boundaries was fetched twice.

    ``device``: where array leaves land, as for ``ckpt.restore``: ``cuda``
    unless ``"cpu"`` is asked for; with no GPU and no explicit request
    this raises.
    """
    device = resolve_device(device)
    if step is None:
        step = latest_step(store, prefix)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {prefix}")
    manifest = load_manifest(store, prefix, step)
    g = manifest.metadata.get("gang")
    if not g:
        raise ValueError(f"step {step} under {prefix} is not a gang image")
    if n_ranks is None:
        n_ranks = int(g["ranks"])
    sharded = {k: int(v) for k, v in g.get("sharded", {}).items()}
    routed = g.get("routed", {})
    plane = plane or DataPlaneConfig()
    cstore = _CountingStore(store)
    pool = shared_executor("fetch", plane.fetch_workers) \
        if plane.fetch_workers > 1 else None
    source = _ChunkSource(cstore, manifest.codec, prefix, pool,
                          plane.max_inflight_bytes)
    # plan every (region, chunk) use up front so the single-flight source
    # prefetches each distinct decode once and evicts after its last use
    plans: List[tuple] = []
    for name, li in manifest.leaves.items():
        shape = tuple(li.shape)
        if name in sharded:
            regs = [rank_region(shape, n_ranks, r, sharded[name])
                    for r in range(n_ranks)]
        else:
            regs = [((0,) * len(shape), shape)]
        plans.append((name, li, regs))
        for chunk in li.chunks:
            for off, shp in regs:
                if _overlap(off, shp, tuple(chunk.offset),
                            tuple(chunk.shape)):
                    source.register(li, chunk)
    parts: Dict[str, List[np.ndarray]] = {}
    full: Dict[str, np.ndarray] = {}
    try:
        for name, li, regs in plans:
            if name in sharded:
                parts[name] = [_assemble_region(source, li, off, shp)
                               for off, shp in regs]
            else:
                full[name] = _assemble_region(source, li, *regs[0])
    except BaseException:
        source.cancel_pending()
        raise
    trees: List[Dict[str, Any]] = []
    for r in range(n_ranks):
        tree: Dict[str, Any] = {}
        for name, li, _ in plans:
            if name in sharded:
                tree[name] = parts[name][r]
            elif name in routed:
                spec = routed[name]
                by = manifest.leaves[spec["by"]]
                dim = int(by.shape[sharded.get(spec["by"], 0)])
                col = int(spec["col"])
                msgs = full[name]
                rows = [i for i in range(msgs.shape[0])
                        if owner_of_row(dim, n_ranks,
                                        int(msgs[i, col])) == r]
                tree[name] = msgs[rows] if rows else \
                    np.zeros((0, msgs.shape[1]), msgs.dtype)
            elif li.kind == "scalar":
                tree[name] = full[name].item()
            else:
                tree[name] = full[name].copy()
            if isinstance(tree[name], np.ndarray):
                tree[name] = to_tensor(tree[name], li.dtype, device)
        trees.append(tree)
    counts = list(cstore.fetches.values())
    stats = {"chunk_fetches": sum(counts), "unique_chunks": len(counts),
             "max_fetches_per_chunk": max(counts) if counts else 0,
             "bytes_fetched": cstore.bytes_fetched}
    return trees, manifest, stats


class GangCheckpointer:
    """Per-rank incremental dedup threaded across gang epochs.

    Holds one digest table per rank scope so repeat content skips its put
    (same contract as ``AsyncCheckpointer._known``, per rank). The tables
    survive aborted epochs — an aborted epoch's chunks stay in the store
    until a sweep, at which point ``invalidate`` drops exactly the swept
    scopes' digests (checkpoint_manager wires GC's ``on_swept`` here)."""

    def __init__(self, store: ObjectStore, prefix: str, *,
                 codec: str = "raw",
                 plane: Optional[DataPlaneConfig] = None):
        self.store = store
        self.prefix = prefix
        self.codec = codec
        self.plane = plane or DataPlaneConfig()
        self._lock = threading.Lock()
        self._knowns: Optional[List[Dict[str, int]]] = None

    def save(self, step: int, rank_trees: Sequence[Dict[str, Any]], *,
             sharded: Dict[str, int],
             routed: Optional[Dict[str, Dict[str, Any]]] = None,
             metadata: Optional[Dict[str, Any]] = None) -> Manifest:
        n = len(rank_trees)
        with self._lock:
            if self._knowns is None or len(self._knowns) != n:
                prev = scoped_known_digests(self.store, self.prefix,
                                            before_step=step)
                self._knowns = [dict(prev.get(r, {})) for r in range(n)]
            knowns = self._knowns
        return save_gang_image(self.store, self.prefix, step, rank_trees,
                               sharded=sharded, routed=routed,
                               codec=self.codec, metadata=metadata,
                               plane=self.plane, knowns=knowns)

    def invalidate(self, keys: Sequence[str]) -> None:
        with self._lock:
            if not self._knowns:
                return
            for key in keys:
                rank, digest = scope_of_key(key)
                if rank is not None and rank < len(self._knowns):
                    self._knowns[rank].pop(digest, None)

    def reset(self) -> None:
        with self._lock:
            self._knowns = None
