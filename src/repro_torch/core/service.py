"""CACS service facade — the paper's REST resource model (Table 1).

Resources:
  coordinators:  GET /coordinators            -> list_coordinators()
                 POST /coordinators           -> submit(asr)
  coordinator:   GET /coordinators/:id        -> get_coordinator(id)
                 DELETE /coordinators/:id     -> delete_coordinator(id)
  checkpoints:   GET  .../:id/checkpoints      -> list_checkpoints(id)
                 POST .../:id/checkpoints      -> trigger_checkpoint(id) or
                                                  upload_checkpoint(id, ...)
  checkpoint:    GET  .../checkpoints/:step    -> get_checkpoint(id, step)
                 POST .../checkpoints/:step    -> restart_from(id, step)
                 DELETE .../checkpoints/:step  -> delete_checkpoint(id, step)

Requests are handled by a background thread pool (paper §6.5); the facade is
stateless over CoordinatorDB + object stores, so a crashed service instance
restarts with no loss (paper §6.4).

This module is the paper's §2 "checkpointing as a service" contract in one
class: non-invasive (any `core/application.py` Application is accepted),
cloud-agnostic (backends are named entries in the CloudManager registry,
§4.2), and the substrate for all four §2.2 use cases — long-running job
support (1), job swapping under over-subscription (2, via
`core/scheduler.py`), proactive suspend of degraded jobs (3, via
`core/monitoring.py`), and cross-cloud migration (4, via
`core/migration.py`). See README.md for the full paper→module map.

Port of ``repro/core/service.py``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.ckpt.plane import DataPlaneConfig
from repro_torch.ckpt.storage import InMemoryStore, ObjectStore
from repro_torch.clusters.base import ClusterBackend
from repro_torch.core.app_manager import AppManager
from repro_torch.core.checkpoint_manager import CheckpointManager
from repro_torch.core.cloud_manager import CloudManager
from repro_torch.core.coordinator import (ASR, Coordinator, CoordinatorDB,
                                          CoordState)
from repro_torch.core.provision import ProvisionManager
from repro_torch.sim.simtime import active_clock


class CACSService:
    def __init__(self, backends: Dict[str, ClusterBackend],
                 stores: Optional[Dict[str, ObjectStore]] = None,
                 db_store: Optional[ObjectStore] = None,
                 start_daemons: bool = True,
                 workers: int = 100,
                 ckpt_plane: Optional[DataPlaneConfig] = None,
                 lowperf=None):
        stores = stores or {"default": InMemoryStore()}
        self.db = CoordinatorDB(db_store)
        if db_store is not None:
            # restartability (paper §6.4): a service instance given a
            # persistent db store rehydrates its coordinator records (sans
            # live app/VMs) — their images and step history are intact, so
            # restart_from resumes them once an app factory is re-attached
            self.db.load()
        self.cloud = CloudManager(backends)
        self.provision = ProvisionManager()
        # service-wide checkpoint data-plane parallelism (swap-out, periodic
        # saves, restores and image ingest all ride it); per-app override
        # via CheckpointPolicy.plane
        self.ckpt = CheckpointManager(stores, plane=ckpt_plane)
        # lowperf: optional core.monitoring.LowPerfConfig enabling the
        # telemetry-driven throughput watchdog (None = liveness only)
        self.apps = AppManager(self.db, self.cloud, self.provision,
                               self.ckpt, workers=workers, lowperf=lowperf)
        # optional cross-cloud replication (core/replication.py); attached
        # via attach_replicator so standby wiring stays explicit
        self.replicator = None
        # optional cloud-spanning scheduler (core/scheduler.py); attached
        # via attach_scheduler so it is stopped with the service
        self.scheduler = None
        # route native failure notifications (Snooze path, §6.1)
        for backend in backends.values():
            if backend.supports_failure_notifications:
                backend.subscribe_failures(self._native_failure)
        if start_daemons:
            self.apps.start_checkpoint_daemon()

    def _native_failure(self, vm) -> None:
        coord_id = vm.host.owner
        if coord_id:
            self.apps.monitor.on_native_failure(coord_id)

    # ---- coordinators resource -----------------------------------------
    def list_coordinators(self) -> List[Dict[str, Any]]:
        return [c.to_dict() for c in self.db.list()]

    def submit(self, asr: ASR, block: bool = False) -> str:
        return self.apps.submit(asr, block=block).coord_id

    # ---- coordinator resource ------------------------------------------
    def get_coordinator(self, coord_id: str) -> Dict[str, Any]:
        return self.db.get(coord_id).to_dict()

    def delete_coordinator(self, coord_id: str) -> Dict[str, Any]:
        return self.apps.terminate(coord_id)

    # ---- checkpoints resource ------------------------------------------
    def list_checkpoints(self, coord_id: str) -> List[int]:
        return self.ckpt.list_images(self.db.get(coord_id))

    def trigger_checkpoint(self, coord_id: str, *,
                           blocking: bool = True) -> int:
        return self.apps.checkpoint_now(coord_id, blocking=blocking)

    def upload_checkpoint(self, coord_id: str, src_store: ObjectStore,
                          src_prefix: str, step: int) -> None:
        self.ckpt.upload_image(self.db.get(coord_id), src_store,
                               src_prefix, step)

    # ---- checkpoint resource -------------------------------------------
    def get_checkpoint(self, coord_id: str, step: int) -> Dict[str, Any]:
        return self.ckpt.image_info(self.db.get(coord_id), step)

    def restart_from(self, coord_id: str, step: Optional[int] = None) -> None:
        self.apps.restart_from(coord_id, step)

    def delete_checkpoint(self, coord_id: str, step: int) -> None:
        self.ckpt.delete_image(self.db.get(coord_id), step)

    # ---- replication (core/replication.py) ------------------------------
    def attach_replicator(self, replicator) -> None:
        """Register this service's ImageReplicator so replication state is
        queryable through the facade and shut down with the service."""
        self.replicator = replicator

    def replication_stats(self, coord_id: str) -> Dict[str, Any]:
        """Per-target replication lag / RPO / copy counters for one app
        ({} when no replicator is attached or the app is not replicated)."""
        if self.replicator is None:
            return {}
        return self.replicator.replication_stats(coord_id)

    # ---- scheduling (core/scheduler.py) ----------------------------------
    def attach_scheduler(self, scheduler) -> None:
        """Register this service's GlobalScheduler so it is shut down with
        the service and queryable through the facade."""
        self.scheduler = scheduler

    def scheduler_stats(self) -> Dict[str, Any]:
        """Queue depth / preemption / backfill counters of the attached
        scheduler ({} when none is attached)."""
        if self.scheduler is None:
            return {}
        return self.scheduler.stats()

    # ---- convenience -----------------------------------------------------
    def wait_for_state(self, coord_id: str, state: CoordState,
                       timeout: float = 30.0) -> Coordinator:
        # the safety deadline stays on the wall clock (bounds real test
        # time); the poll pacing goes through the installed clock so a
        # virtual-time run advances instead of wall-sleeping
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            coord = self.db.get(coord_id)
            if coord.state == state:
                return coord
            if coord.state == CoordState.ERROR and state != CoordState.ERROR:
                raise RuntimeError(
                    f"{coord_id} entered ERROR: {coord.error}")
            active_clock().sleep(0.005)
        raise TimeoutError(
            f"{coord_id} did not reach {state.value} in {timeout}s "
            f"(now {self.db.get(coord_id).state.value})")

    def shutdown(self) -> None:
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.replicator is not None:
            self.replicator.stop()
        self.apps.stop_daemons()
        for coord in list(self.db.list()):
            try:
                if coord.state not in (CoordState.TERMINATED,):
                    self.apps.terminate(coord.coord_id)
            except Exception:                      # noqa: BLE001
                pass
        self.provision.close()
