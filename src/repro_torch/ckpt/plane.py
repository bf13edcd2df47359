"""Parallel checkpoint data-plane primitives.

The checkpoint hot path (writer.py save, reader.py restore, storage.py
two-tier replication) is embarrassingly parallel per content-addressed
chunk, and on any store with latency or bandwidth cost (the paper's
NFS/S3/Ceph roles) a serial loop pays ~sum-of-chunks when the hardware
allows ~max-of-chunks. This module holds the pieces every stage shares:

  * ``DataPlaneConfig`` — the user-facing knobs (encode workers, upload
    workers, fetch workers, max in-flight bytes) plumbed through
    ``save_checkpoint`` / ``AsyncCheckpointer`` / ``restore`` /
    ``CheckpointManager``;
  * ``ByteBudget``    — condition-variable backpressure bounding the bytes
    held between pipeline stages (a save of a model larger than host RAM
    headroom must not buffer every encoded chunk at once);
  * ``SingleFlight``  — per-key deduplication of concurrent work: the
    first worker to claim a key does the work, everyone else blocks until
    the result lands. This is what keeps dedup counters and
    bytes-written *identical* to the serial plane no matter how the
    scheduler interleaves workers.

Crash safety is unaffected by any of this: the commit protocol (all chunk
puts durable -> manifest -> flush -> COMMITTED) only requires that the
writer join every upload before putting the manifest, which the pipeline
does by construction (see writer._write_staged).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.obs.telemetry import registry
from repro_torch.sim.simtime import active_clock


@dataclasses.dataclass(frozen=True)
class PreEncodedChunk:
    """A chunk that enters the save pipeline already encoded.

    Produced by device-side encode (``kernels.qsnap.qsnap_encode_chunks``
    quantizes on the accelerator so the D2H copy carries int8+scales, not
    f32). The writer's encode stage becomes pass-through: the payload is
    digested as-is, so a device-encoded chunk and a host-encoded chunk of
    the same content share one CAS entry bit-for-bit.

    ``codec`` names the codec this payload already satisfies ("int8");
    the save's image codec must equal it or be a zlib-refinement of it
    (writer._adapt_pre_encoded). ``nbytes`` feeds the ByteBudget exactly
    like a host ndarray would.
    """
    data: bytes
    codec: str

    @property
    def nbytes(self) -> int:
        return len(self.data)


@dataclasses.dataclass(frozen=True)
class DataPlaneConfig:
    """Knobs for the parallel checkpoint data plane.

    encode_workers:    threads running codec + digest on the save path.
    upload_workers:    threads running store puts on the save path (also
                       the stream count for parallel image ingest in
                       CheckpointManager.upload_image).
    fetch_workers:     threads running store gets + decode on restore.
    max_inflight_bytes: cap on raw bytes admitted into the save pipeline
                       but not yet durable (backpressure; <=0 = unbounded).

    ``workers=1`` everywhere reproduces the serial plane exactly — same
    puts, same counters, same ordering — so correctness never depends on
    parallelism being enabled.
    """
    encode_workers: int = 2
    upload_workers: int = 4
    fetch_workers: int = 4
    max_inflight_bytes: int = 256 << 20

    @classmethod
    def serial(cls) -> "DataPlaneConfig":
        return cls(encode_workers=1, upload_workers=1, fetch_workers=1,
                   max_inflight_bytes=0)

    @classmethod
    def with_workers(cls, n: int) -> "DataPlaneConfig":
        """Uniform worker count across all three stages (benchmarks)."""
        return cls(encode_workers=n, upload_workers=n, fetch_workers=n)

    @property
    def serial_save(self) -> bool:
        return self.encode_workers <= 1 and self.upload_workers <= 1


# Process-wide executor cache. A training job checkpoints every few
# seconds/minutes; spawning (encode+upload+fetch) thread pools per save
# costs more wall time than the chunk work it parallelizes (thread-spawn
# storm + GIL convoy measured at ~15ms for 16 threads). Pools are keyed by
# (stage, workers) — a handful of configs exist per process — and shared
# by all concurrent saves/restores: jobs interleave in the queue and each
# caller joins only its own futures, so sharing cannot deadlock (claims
# are only ever held by *running* jobs; see SingleFlight).
_POOLS: Dict[Tuple[str, int], cf.ThreadPoolExecutor] = {}
_POOLS_LOCK = threading.Lock()


def shared_executor(stage: str, workers: int) -> cf.ThreadPoolExecutor:
    with _POOLS_LOCK:
        ex = _POOLS.get((stage, workers))
        if ex is None:
            ex = cf.ThreadPoolExecutor(
                workers, thread_name_prefix=f"ckpt-{stage}{workers}")
            _POOLS[(stage, workers)] = ex
        return ex


class ByteBudget:
    """Bounded admission of bytes into the pipeline (backpressure).

    ``acquire`` blocks while the budget is exhausted — except that a
    single item larger than the whole budget is always admitted when the
    pipeline is empty, so an oversized chunk can never deadlock the save.

    ``name`` prefixes the telemetry this budget publishes (the save path
    and replication each own a budget): ``<name>.budget_wait_s`` histogram
    of admission stalls and a ``<name>.inflight_bytes`` high-water gauge.
    """

    def __init__(self, limit: int, name: str = "plane"):
        self._limit = limit
        self._used = 0
        self._cv = threading.Condition()
        self._metric = name

    def acquire(self, nbytes: int) -> None:
        if self._limit <= 0:
            return
        reg = registry()
        with self._cv:
            if reg.enabled and self._used > 0 \
                    and self._used + nbytes > self._limit:
                clk = active_clock()
                t0 = clk.now()
                while self._used > 0 and self._used + nbytes > self._limit:
                    self._cv.wait()
                reg.observe(f"{self._metric}.budget_wait_s",
                            (clk.now() - t0) / clk.scale)
            else:
                while self._used > 0 and self._used + nbytes > self._limit:
                    self._cv.wait()
            self._used += nbytes
            if reg.enabled:
                reg.gauge_max(f"{self._metric}.inflight_bytes",
                              float(self._used))

    def release(self, nbytes: int) -> None:
        if self._limit <= 0:
            return
        with self._cv:
            self._used -= nbytes
            self._cv.notify_all()


class SingleFlight:
    """Per-key collapse of concurrent duplicate work.

    ``claim(key)`` returns True for exactly one caller per key *lifetime*;
    everyone else blocks until the claimant calls ``done(key)`` and then
    returns False (the result is expected in a caller-owned table, e.g.
    the writer's ``known`` digest map). If the claimant fails, ``abort``
    wakes the waiters and lets the next one claim — work is retried, not
    lost.
    """

    def __init__(self, lock: Optional[threading.Lock] = None):
        self._lock = lock or threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight: Dict[str, bool] = {}

    def claim(self, key: str, have) -> bool:
        """have() is evaluated under the lock: return True when the
        result already exists and no work (or wait) is needed."""
        with self._cv:
            while True:
                if have():
                    return False
                if key not in self._inflight:
                    self._inflight[key] = True
                    return True
                self._cv.wait()

    def done(self, key: str) -> None:
        with self._cv:
            self._inflight.pop(key, None)
            self._cv.notify_all()

    abort = done
