"""Checkpoint Manager (paper §6.2): application-image lifecycle over
pluggable storage backends.

Stateless by design: "The Checkpoint Manager is not aware of the existence
of checkpoint images until a restart is required. At that time [it] will
choose the most recent checkpoint image by default, but a user may also
specify an earlier image." — reproduced verbatim: all queries go to the
store's committed manifests; nothing is cached in the manager.

Port of ``repro/core/checkpoint_manager.py``. An image lands on the
device its application declares (``app.device``), passed to the reader
explicitly, so nothing depends on the current device of the service
thread that runs the restore; ``load(shardings=)`` places leaves as
DTensor shards on a mesh of that device type, as the reader does. An
application that declares no device is refused; it never lands on the
CPU by default.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.ckpt import gc as ckpt_gc
from repro_torch.ckpt.gang import GangCheckpointer, load_gang_ranks
from repro_torch.ckpt.plane import DataPlaneConfig, shared_executor
from repro_torch.ckpt.reader import (latest_step, list_steps, load_manifest,
                                     restore)
from repro_torch.ckpt.storage import ObjectStore
from repro_torch.ckpt.writer import AsyncCheckpointer, save_checkpoint
from repro_torch.core.coordinator import CheckpointPolicy, Coordinator
from repro_torch.obs.trace import tracer


def app_device(coord: Coordinator) -> torch.device:
    """The device the coordinator's application declares: its images
    restore there. Raises when there is no application or it names no
    device."""
    dev = getattr(coord.app, "device", None)
    if dev is None:
        what = ("no application" if coord.app is None else
                f"application {type(coord.app).__name__} declares no device")
        raise ValueError(f"{coord.coord_id}: {what}; an image restores onto "
                         f"the device its application names (app.device)")
    return torch.device(dev)


class CheckpointManager:
    def __init__(self, stores: Dict[str, ObjectStore],
                 plane: Optional[DataPlaneConfig] = None):
        self._stores = dict(stores)
        self._async: Dict[str, AsyncCheckpointer] = {}
        self._gangs: Dict[str, GangCheckpointer] = {}
        self._lock = threading.Lock()
        # service-wide default for the parallel checkpoint data plane;
        # CheckpointPolicy.plane overrides per application
        self.plane = plane or DataPlaneConfig()

    def _plane_for(self, coord: Coordinator) -> DataPlaneConfig:
        return getattr(coord.asr.policy, "plane", None) or self.plane

    def store(self, name: str = "default") -> ObjectStore:
        if name not in self._stores:
            raise KeyError(f"unknown store {name!r}; have {sorted(self._stores)}")
        return self._stores[name]

    def register_store(self, name: str, store: ObjectStore) -> None:
        with self._lock:
            self._stores[name] = store

    # ---- save ----------------------------------------------------------
    def save(self, coord: Coordinator, step: int, state: Any, *,
             blocking: bool = True,
             metadata: Optional[Dict[str, Any]] = None,
             codec: Optional[str] = None) -> None:
        """Save ``state`` — a materialized pytree or a SnapshotHandle.

        A handle is resolved on the coordinator's writer thread (both
        blocking and async paths), so the device→host copy never runs on
        the caller — ``checkpoint_now``/``suspend`` hold the app stalled
        only for the microsecond capture. ``codec`` overrides the
        policy's image codec for this save (suspend passes
        ``policy.swap_codec``).
        """
        pol = coord.asr.policy
        store = self.store(pol.store)
        save_codec = codec or pol.codec
        meta = {"app": coord.asr.name, **(metadata or {})}

        def run_gc(_step=None):
            if pol.keep_last:
                # Invalidate writer-side dedup caches for whatever the sweep
                # reaps. The async writer's own commits already prune its
                # caches (writer._absorb), but interleaved *blocking* saves
                # can age the async writer's last manifest out of the keep
                # window — at which point its cached digests point at
                # sweepable chunks.
                with self._lock:
                    ck = self._async.get(coord.coord_id)
                ckpt_gc.collect(store, coord.ckpt_prefix,
                                keep_last=pol.keep_last,
                                keep_every=pol.keep_every,
                                on_swept=(None if ck is None
                                          else ck.invalidate))

        if blocking:
            parent = tracer().current()    # the caller's span, on its thread

            def _save_and_gc():
                save_checkpoint(store, coord.ckpt_prefix, step, state,
                                codec=save_codec, metadata=meta,
                                plane=self._plane_for(coord),
                                trace_id=getattr(coord, "trace_id", ""),
                                parent=parent)
                run_gc()
            # Run the blocking save + GC on the coordinator's writer
            # thread (creating it if needed — checking for an existing one
            # would be TOCTOU against a concurrent async save creating
            # it), after any in-flight async save. Otherwise this GC's
            # sweep_orphans could reap chunks an in-flight save has put
            # but not yet committed — committing a manifest that
            # references reaped keys (the invariant delete_image already
            # serializes the same way).
            self._checkpointer(coord).run_serialized(_save_and_gc)
        else:
            # GC must run post-commit, or it would count the in-flight step
            ck = self._checkpointer(coord)
            ck.save(step, state, metadata=meta, on_commit=run_gc,
                    codec=None if save_codec == ck.codec else save_codec)

    def _checkpointer(self, coord: Coordinator) -> AsyncCheckpointer:
        with self._lock:
            if coord.coord_id not in self._async:
                pol = coord.asr.policy
                self._async[coord.coord_id] = AsyncCheckpointer(
                    self.store(pol.store), coord.ckpt_prefix, codec=pol.codec,
                    plane=self._plane_for(coord),
                    trace_id=getattr(coord, "trace_id", ""))
            return self._async[coord.coord_id]

    # ---- gang images (core/gang.py barrier protocol) -------------------
    def save_gang(self, coord: Coordinator, step: int, rank_trees: List[Any],
                  *, sharded: Dict[str, int],
                  routed: Optional[Dict[str, Dict[str, Any]]] = None,
                  metadata: Optional[Dict[str, Any]] = None) -> Any:
        """Commit one all-or-nothing gang image (called from inside the
        barrier's SAVE phase — blocking by construction: the ranks stay
        quiesced until every chunk joined and the marker is durable).
        Raises without side effects beyond orphan chunks on any rank's
        storage fault; the barrier turns that into an epoch abort."""
        pol = coord.asr.policy
        store = self.store(pol.store)
        ck = self._gang_checkpointer(coord)
        meta = {"app": coord.asr.name, "trace_id": coord.trace_id,
                **(metadata or {})}
        manifest = ck.save(step, rank_trees, sharded=sharded, routed=routed,
                           metadata=meta)
        if pol.keep_last:
            ckpt_gc.collect(store, coord.ckpt_prefix, keep_last=pol.keep_last,
                            keep_every=pol.keep_every, on_swept=ck.invalidate)
        return manifest

    def load_gang(self, coord: Coordinator, step: Optional[int] = None, *,
                  n_ranks: Optional[int] = None) -> Any:
        """(per-rank trees, manifest, fetch stats) resharded onto
        ``n_ranks`` — the restore half of elastic shrink/grow."""
        return load_gang_ranks(self.store(coord.asr.policy.store),
                               coord.ckpt_prefix, step, n_ranks,
                               plane=self._plane_for(coord),
                               device=app_device(coord))

    def _gang_checkpointer(self, coord: Coordinator) -> GangCheckpointer:
        with self._lock:
            ck = self._gangs.get(coord.coord_id)
            if ck is None:
                pol = coord.asr.policy
                ck = GangCheckpointer(self.store(pol.store),
                                      coord.ckpt_prefix, codec=pol.codec,
                                      plane=self._plane_for(coord))
                self._gangs[coord.coord_id] = ck
            return ck

    def detach(self, coord_id: str) -> None:
        """Forget the coordinator's cached async writer, draining any
        in-flight save first. Required when a coordinator is *retargeted*
        to a different store (cross-cloud backfill adopts the replicated
        prefix on another cloud's store): the cached writer is bound to
        the old store and would commit post-resume saves to the wrong
        cloud."""
        with self._lock:
            ck = self._async.pop(coord_id, None)
            self._gangs.pop(coord_id, None)  # gang writers are synchronous
        if ck is not None:                   # (barrier-held): drop is safe
            # drain without raising: a failed in-flight save is already
            # consumed by the suspend/recovery path; detaching only needs
            # quiescence before the writer is rebound to the new store
            ck.wait(raise_error=False)
            ck.close()

    def wait(self, coord: Coordinator, strict: bool = True):
        """Join any in-flight async save. strict=False swallows a failed
        save (returning the exception): the recovery/terminate paths only
        need quiescence — the newest COMMITTED image is still intact, the
        torn step is invisible, and its orphan chunks are swept by GC."""
        with self._lock:
            ck = self._async.get(coord.coord_id)
        if ck is None:
            return None
        if strict:
            ck.wait()
            return None
        try:
            ck.wait()
        except Exception as e:                     # noqa: BLE001
            return e
        return None

    # ---- query / restore -------------------------------------------------
    def list_images(self, coord: Coordinator) -> List[int]:
        return list_steps(self.store(coord.asr.policy.store),
                          self.read_prefix(coord))

    def image_info(self, coord: Coordinator, step: int) -> Dict[str, Any]:
        man = load_manifest(self.store(coord.asr.policy.store),
                            coord.ckpt_prefix, step)
        nbytes = sum(c.nbytes for li in man.leaves.values()
                     for c in li.chunks)
        return {"step": man.step, "codec": man.codec, "bytes": nbytes,
                "format_version": man.version,
                "dedup": man.metadata.get("dedup"),
                "leaves": len(man.leaves), "metadata": man.metadata}

    def dedup_stats(self, coord: Coordinator) -> Dict[str, int]:
        """Cumulative incremental-checkpointing counters for one app:
        store-level dedup hits/misses plus the async writer's cache hits
        (which never reach the store). bytes_deduped / (bytes_written +
        bytes_deduped) is the fraction of image bytes incrementality saved."""
        out = dict(self.store(coord.asr.policy.store).dedup_stats())
        with self._lock:
            ck = self._async.get(coord.coord_id)
        if ck is not None:
            out.update({f"writer_{k}": v for k, v in ck.stats().items()})
        return out

    def read_prefix(self, coord: Coordinator,
                    store: Optional[ObjectStore] = None) -> str:
        """The prefix restores should read: the coordinator's own prefix
        once it holds a committed image, else its ``ckpt_adopt_prefix``
        (serving-fleet scale-out: a fresh replica cold-starts from the
        shared seed lineage — pure CAS reads, zero chunk copies — while
        its own saves open a private lineage under ``ckpt_prefix``).
        Writes, GC and delete paths NEVER use this: they stay on the own
        prefix, so terminating a replica can't reap the seed image.
        getattr: tests drive this manager with duck-typed coordinator
        stand-ins that predate the adoption field."""
        adopt = getattr(coord, "ckpt_adopt_prefix", "")
        if not adopt:
            return coord.ckpt_prefix
        store = store if store is not None \
            else self.store(coord.asr.policy.store)
        if latest_step(store, coord.ckpt_prefix) is not None:
            return coord.ckpt_prefix
        return adopt

    def latest(self, coord: Coordinator) -> Optional[int]:
        return latest_step(self.store(coord.asr.policy.store),
                           self.read_prefix(coord))

    def load(self, coord: Coordinator, step: Optional[int] = None, *,
             shardings: Any = None, target: Any = None) -> Any:
        """Restore an image onto the device of ``coord``'s application."""
        tree, _ = restore(self.store(coord.asr.policy.store),
                          self.read_prefix(coord), step,
                          target=target, shardings=shardings,
                          device=app_device(coord),
                          plane=self._plane_for(coord),
                          trace_id=getattr(coord, "trace_id", ""))
        return tree

    # ---- upload (migration ingest; paper §5.3 "upload a checkpoint") ----
    def upload_image(self, coord: Coordinator, src_store: ObjectStore,
                     src_prefix: str, step: int) -> None:
        """Copy a committed image from another service's store (clone).

        Chunks are resolved through the source *manifest* (content-addressed
        chunks live outside the step directory), rewritten onto this app's
        prefix, and deduped on ingest: chunks the destination already holds
        (e.g. from an earlier clone of the same lineage) are not re-uploaded.

        Warm path: when the ImageReplicator (core/replication.py) has
        already shipped a chunk to the destination side — it lives in the
        destination store under the *source* prefix — the copy is sourced
        from that local replica instead of crossing the inter-cloud link
        again (counted in ``replica_hits``/``replica_bytes_local``).
        Cross-cloud transfer then moves only the unreplicated delta.

        The per-chunk copies are independent, so they run on the parallel
        data plane's upload streams — cross-cloud transfer (the dominant
        term of migration, paper Table 3) overlaps source gets with
        destination puts. The commit protocol is the writer's: every chunk
        durable, then manifest, flush, COMMITTED.
        """
        from repro_torch.ckpt.layout import MANIFEST, step_prefix
        from repro_torch.ckpt.reader import load_manifest as _load
        dst = self.store(coord.asr.policy.store)
        man = _load(src_store, src_prefix, step)
        dst_sp = step_prefix(coord.ckpt_prefix, step)

        def copy_chunk(c) -> None:
            new_key = coord.ckpt_prefix + c.key[len(src_prefix):]
            if dst.exists(new_key):          # ingest dedup: count, skip the
                dst.count_ingest_hit(c.nbytes)  # source read entirely
                return
            if dst is not src_store and dst.exists(c.key):
                # warm migration: a replica of this chunk is already on
                # the destination side — copy store-locally, not across
                # the inter-cloud link. The replica may vanish between the
                # exists check and the read (the replicator mirrors
                # primary GC pruning concurrently); fall back to the
                # cross-cloud source rather than failing the clone.
                try:
                    data = dst.get(c.key)
                except (KeyError, FileNotFoundError):
                    data = None
                if data is not None:
                    dst.count_replica_hit(c.nbytes)
                    dst.put_if_absent(new_key, data)
                    return
            dst.put_if_absent(new_key, src_store.get(c.key))

        unique = {c.key: c for li in man.leaves.values()
                  for c in li.chunks}
        workers = max(1, self._plane_for(coord).upload_workers)
        if workers == 1 or len(unique) <= 1:
            for c in unique.values():
                copy_chunk(c)
        else:
            ex = shared_executor("up", workers)
            for fut in [ex.submit(copy_chunk, c) for c in unique.values()]:
                fut.result()                 # join: all chunks durable
        manifest_json = man.to_json().replace(src_prefix, coord.ckpt_prefix)
        dst.put(f"{dst_sp}/{MANIFEST}", manifest_json.encode())
        dst.flush()
        dst.put(f"{dst_sp}/COMMITTED", b"1")
        dst.flush()                          # marker durable, like writer.py

    def delete_image(self, coord: Coordinator, step: int) -> None:
        from repro_torch.ckpt.layout import step_prefix
        store = self.store(coord.asr.policy.store)
        with self._lock:
            ck = self._async.get(coord.coord_id)
            gck = self._gangs.get(coord.coord_id)

        def _delete():
            store.delete_prefix(step_prefix(coord.ckpt_prefix, step))
            # chunks may be shared with surviving steps — sweep, don't
            # prefix-delete
            swept = ckpt_gc.sweep_orphans(store, coord.ckpt_prefix)
            if swept:
                if ck is not None:
                    ck.invalidate(swept)  # a stale dedup hit would commit a
                if gck is not None:       # manifest pointing at reaped chunks
                    gck.invalidate(swept)
        if ck is not None:
            # serialize with in-flight saves: sweeping concurrently could
            # reap chunks a save has put but not yet committed
            ck.run_serialized(_delete)
        else:
            _delete()

    def delete_all(self, coord: Coordinator) -> None:
        with self._lock:
            ck = self._async.pop(coord.coord_id, None)
            self._gangs.pop(coord.coord_id, None)
        if ck is not None:
            ck.close()                   # drain in-flight save first, or it
        self.store(coord.asr.policy.store).delete_prefix(coord.ckpt_prefix)
        # would re-create keys under the prefix after the delete
