"""Pluggable checkpoint object stores (paper §6.2: NFS / S3 / Ceph).

Three backends mirror the paper's storage design:
  * ``InMemoryStore`` — dict-backed; optional simulated latency/bandwidth so
    the paper's figures (upload/download time vs size) are reproducible on a
    single host.
  * ``LocalFSStore``  — directory-backed (the paper's "NFS" role).
  * ``TwoTierStore``  — fast local tier + lazy async upload to a remote tier
    (paper §5.2: "written first to local storage, copied later to remote
    storage on a lazy basis"), replicated over N concurrent uploader streams.

All stores are safe under the parallel data plane (ckpt/plane.py):
``put_if_absent`` is atomic per key (an exists+put race between two workers
can neither double-write nor double-count), and the dedup/GC counters are
instance-level and lock-protected.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.sim.simtime import active_clock


class ObjectStore:
    """Abstract flat key/value object store (S3-shaped).

    Content-addressed (dedup) traffic goes through ``put_if_absent`` /
    ``delete_unreferenced`` so every backend uniformly tracks dedup
    hit/miss counters and never deletes a chunk that a live manifest still
    references (see ckpt/gc.py for how refcounts are derived).

    Subclasses must call ``super().__init__()`` (counter + lock setup).
    """

    def __init__(self):
        # dedup counters — instance-level and guarded by _meta_lock so
        # concurrent writers can't lose updates (the old class-level
        # defaults made `self.x += 1` a read-copy-update race).
        self.dedup_hits = 0               # puts skipped: content already stored
        self.dedup_misses = 0             # puts that actually wrote
        self.dedup_bytes_skipped = 0      # encoded bytes NOT rewritten
        self.gc_deleted = 0               # chunks removed by refcount-aware delete
        # replica-aware transfer counters: chunks sourced from a local
        # replica (shipped earlier by core/replication.py) instead of being
        # re-transferred cross-cloud — the warm-migration savings
        self.replica_hits = 0
        self.replica_bytes_local = 0
        self._meta_lock = threading.Lock()
        self._inflight_cv = threading.Condition(self._meta_lock)
        self._inflight_puts: Set[str] = set()

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        n = 0
        for k in list(self.list(prefix)):
            self.delete(k)
            n += 1
        return n

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Content-addressed put: skip (and count a dedup hit) when the key
        already holds this content. Returns True iff data was written.

        Atomic per key: a concurrent put_if_absent of the same key waits
        for the in-flight put instead of racing it, so exactly one caller
        writes (a miss) and the rest count hits — without serializing puts
        of *different* keys through one lock (store latency would otherwise
        flatten the parallel plane back to serial).
        """
        with self._inflight_cv:
            while key in self._inflight_puts:
                self._inflight_cv.wait()
            if self.exists(key):
                self.dedup_hits += 1
                self.dedup_bytes_skipped += len(data)
                return False
            self._inflight_puts.add(key)
        try:
            self.put(key, data)
        finally:
            with self._inflight_cv:
                self._inflight_puts.discard(key)
                self._inflight_cv.notify_all()
        with self._meta_lock:
            self.dedup_misses += 1
        return True

    def delete_unreferenced(self, key: str, refcount: int) -> bool:
        """Refcount-aware delete for shared chunks: remove ``key`` only when
        no live manifest references it. Returns True iff deleted."""
        if refcount > 0:
            return False
        self.delete(key)
        with self._meta_lock:
            self.gc_deleted += 1
        return True

    def dedup_stats(self) -> Dict[str, int]:
        with self._meta_lock:
            return {"dedup_hits": self.dedup_hits,
                    "dedup_misses": self.dedup_misses,
                    "dedup_bytes_skipped": self.dedup_bytes_skipped,
                    "gc_deleted": self.gc_deleted,
                    "replica_hits": self.replica_hits,
                    "replica_bytes_local": self.replica_bytes_local}

    def count_ingest_hit(self, nbytes: int) -> None:
        """Record an ingest-side dedup hit (upload_image skipping a chunk
        the destination already holds) without racing other counters."""
        with self._meta_lock:
            self.dedup_hits += 1
            self.dedup_bytes_skipped += nbytes

    def count_replica_hit(self, nbytes: int) -> None:
        """Record a warm-transfer hit: a chunk that would have crossed the
        inter-cloud link was found in a local replica instead (shipped
        earlier by the ImageReplicator) and copied store-locally."""
        with self._meta_lock:
            self.replica_hits += 1
            self.replica_bytes_local += nbytes

    # Stores that upload lazily override this to block until durable.
    def flush(self) -> None:
        pass

    def total_bytes(self, prefix: str = "") -> int:
        return sum(len(self.get(k)) for k in self.list(prefix))


class InMemoryStore(ObjectStore):
    """Dict-backed store with an optional simulated network cost model.

    ``latency_s`` + len/``bandwidth_bps`` of wall-clock sleep per op lets the
    cluster simulator reproduce the paper's network-bound checkpoint/restart
    curves (Fig 3b/3c) deterministically. Latency is paid concurrently
    (per-op sleep outside any lock — parallel requests overlap it, like
    independent RTTs); bandwidth with ``shared_link=True`` is paid under a
    link lock (parallel requests contend, like one NFS/Ceph ingress pipe).
    """

    def __init__(self, latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None,
                 shared_link: bool = False):
        super().__init__()
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._link_lock = threading.Lock()
        self.latency_s = latency_s
        self.bandwidth_bps = bandwidth_bps
        # shared_link=True serializes bandwidth cost across threads —
        # models a shared NFS/Ceph ingress (paper Fig 3c's restart jitter
        # comes exactly from this contention).
        self.shared_link = shared_link
        self.put_count = 0
        self.get_count = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def _cost(self, nbytes: int) -> None:
        # paid through the installed clock: real sleeps in production,
        # instant virtual advances under a SimClock (repro_torch.sim)
        clk = active_clock()
        if self.latency_s > 0:
            clk.sleep(self.latency_s)
        if self.bandwidth_bps:
            t = nbytes / self.bandwidth_bps
            if self.shared_link:
                with self._link_lock:
                    clk.sleep(t)
            elif t > 0:
                clk.sleep(t)

    def put(self, key: str, data: bytes) -> None:
        self._cost(len(data))
        with self._lock:
            self._data[key] = bytes(data)
            self.put_count += 1
            self.bytes_in += len(data)

    def get(self, key: str) -> bytes:
        with self._lock:
            data = self._data[key]
            self.get_count += 1
            self.bytes_out += len(data)
        self._cost(len(data))
        return data

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def list(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class LocalFSStore(ObjectStore):
    """Directory-backed store. Keys map to files (``/`` allowed in keys).

    Writes are atomic (tmp + rename) so a crashed writer never leaves a
    half-written object visible; concurrent writers use per-process,
    per-thread tmp names (thread ids repeat across processes), so
    parallel puts, of one key from two ranks of a sharded save too, need
    no extra locking.
    """

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.join(self.root, key)
        assert os.path.abspath(p).startswith(os.path.abspath(self.root))
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list(self, prefix: str) -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp") or ".tmp." in fn:
                    continue
                key = os.path.relpath(os.path.join(dirpath, fn), self.root)
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class ChaosStorageError(IOError):
    """Raised by FaultyStore for a deterministically injected op failure."""


class FaultyStore(ObjectStore):
    """Fault-injecting wrapper around any ObjectStore (chaos harness).

    ``arm_put_errors(n)`` / ``arm_get_errors(n)`` make the next *n* put/get
    calls raise :class:`ChaosStorageError` — deterministic (a counter, not a
    probability), so a seeded chaos scenario replays exactly. Because the
    writer's commit protocol puts data chunks before MANIFEST before
    COMMITTED, a put fault injected mid-save must leave the previous
    COMMITTED image fully loadable and the torn step invisible; the chaos
    suite (`tests/test_chaos.py`) holds the store to exactly that.

    Arming takes an optional ``key_prefix``: only ops whose key starts
    with it are faulted. Gang checkpointing writes each rank's chunks
    under a rank-scoped CAS prefix (``<prefix>/cas/r<rank>-``), so a
    prefix-armed fault hits exactly one rank's uploads mid-barrier —
    the single-rank store-fault scenario of `tests/test_gang_chaos.py`.

    The wrapper *is* the store as far as the service is concerned: the
    inherited ``put_if_absent``/``delete_unreferenced`` run against the
    wrapper's counters, and every other op delegates to ``inner``.
    """

    def __init__(self, inner: ObjectStore):
        super().__init__()
        self.inner = inner
        self._fault_lock = threading.Lock()
        self._put_faults = 0
        self._get_faults = 0
        # key_prefix -> remaining faults, for per-rank (scoped) arming
        self._put_prefix_faults: Dict[str, int] = {}
        self._get_prefix_faults: Dict[str, int] = {}
        self.faults_injected = 0

    def arm_put_errors(self, n: int, key_prefix: Optional[str] = None) -> None:
        with self._fault_lock:
            if key_prefix is None:
                self._put_faults = max(0, int(n))
            else:
                self._put_prefix_faults[key_prefix] = max(0, int(n))

    def arm_get_errors(self, n: int, key_prefix: Optional[str] = None) -> None:
        with self._fault_lock:
            if key_prefix is None:
                self._get_faults = max(0, int(n))
            else:
                self._get_prefix_faults[key_prefix] = max(0, int(n))

    def disarm(self) -> None:
        with self._fault_lock:
            self._put_faults = 0
            self._get_faults = 0
            self._put_prefix_faults.clear()
            self._get_prefix_faults.clear()

    def armed(self) -> int:
        with self._fault_lock:
            return (self._put_faults + self._get_faults
                    + sum(self._put_prefix_faults.values())
                    + sum(self._get_prefix_faults.values()))

    def _maybe_fault(self, op: str, key: str) -> None:
        attr = f"_{op}_faults"
        scoped = getattr(self, f"_{op}_prefix_faults")
        with self._fault_lock:
            for pfx, left in scoped.items():
                if left > 0 and key.startswith(pfx):
                    scoped[pfx] = left - 1
                    self.faults_injected += 1
                    raise ChaosStorageError(
                        f"injected {op} fault on {key!r} (scope {pfx!r})")
            if getattr(self, attr) > 0:
                setattr(self, attr, getattr(self, attr) - 1)
                self.faults_injected += 1
                raise ChaosStorageError(f"injected {op} fault on {key!r}")

    def put(self, key: str, data: bytes) -> None:
        self._maybe_fault("put", key)
        self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        self._maybe_fault("get", key)
        return self.inner.get(key)

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def list(self, prefix: str) -> List[str]:
        return self.inner.list(prefix)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def flush(self) -> None:
        self.inner.flush()


class TwoTierStore(ObjectStore):
    """Local tier for writes, lazy background replication to remote tier.

    Reads prefer local, falling back to remote (so a restarted host that
    lost its local tier still restores). Replication runs over
    ``upload_streams`` concurrent uploader threads — on a latency- or
    bandwidth-bound remote (the paper's S3/Ceph roles) the backlog drains
    ~streams× faster, which directly shortens ``flush()``. ``flush()``
    blocks on a condition variable until all pending uploads are durable
    in the remote tier (no polling); the commit marker is only written
    after flush (see writer.py), preserving atomicity.
    """

    def __init__(self, local: ObjectStore, remote: ObjectStore, *,
                 upload_streams: int = 4):
        super().__init__()
        self.local = local
        self.remote = remote
        self.upload_streams = max(1, int(upload_streams))
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._pending: Dict[str, int] = {}
        self._drained = threading.Condition()
        self._err: Optional[BaseException] = None
        self._failed: Set[str] = set()        # replications to retry
        self._threads = [
            threading.Thread(target=self._uploader, daemon=True,
                             name=f"tt-upload-{i}")
            for i in range(self.upload_streams)]
        for t in self._threads:
            t.start()

    def _uploader(self) -> None:
        while True:
            key = self._q.get()
            if key is None:
                return
            try:
                self.remote.put(key, self.local.get(key))
            except BaseException as e:        # surfaced at flush(), which
                with self._drained:           # re-queues the key: a failed
                    self._err = e             # upload stays owed, or a later
                    self._failed.add(key)     # save could commit while the
            finally:                          # remote misses this chunk
                with self._drained:
                    self._pending[key] -= 1
                    if self._pending[key] == 0:
                        del self._pending[key]
                    if not self._pending:
                        self._drained.notify_all()

    def put(self, key: str, data: bytes) -> None:
        self.local.put(key, data)
        with self._drained:
            self._pending[key] = self._pending.get(key, 0) + 1
        self._q.put(key)

    def get(self, key: str) -> bytes:
        try:
            return self.local.get(key)
        except (KeyError, FileNotFoundError):
            return self.remote.get(key)

    def exists(self, key: str) -> bool:
        return self.local.exists(key) or self.remote.exists(key)

    def list(self, prefix: str) -> List[str]:
        return sorted(set(self.local.list(prefix)) |
                      set(self.remote.list(prefix)))

    def delete(self, key: str) -> None:
        self.local.delete(key)
        self.remote.delete(key)

    def flush(self) -> None:
        # Re-queue failed replications first: until every one of them lands
        # remotely, no flush() may return cleanly — otherwise a later save
        # could dedup against the local copy and commit a checkpoint whose
        # chunk exists in no durable tier. Transient remote errors heal on
        # a later flush; persistent ones keep every flush (and therefore
        # every commit) failing.
        with self._drained:
            retry, self._failed = self._failed, set()
            for key in retry:
                self._pending[key] = self._pending.get(key, 0) + 1
        for key in retry:
            self._q.put(key)
        with self._drained:
            while self._pending:
                self._drained.wait()
            if self._err is not None:
                err, self._err = self._err, None
                raise err

    def pending_uploads(self) -> int:
        with self._drained:
            return sum(self._pending.values())

    def drop_local(self) -> None:
        """Simulate losing the fast tier (host failure)."""
        for k in list(self.local.list("")):
            self.local.delete(k)

    def close(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=5)
