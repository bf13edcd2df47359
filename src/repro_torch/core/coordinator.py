"""Coordinator records + lifecycle state machine (paper Fig 2, Table 1).

One coordinator per application, exactly as DMTCP associates one coordinator
per checkpointed computation. We extend the paper's state set with
SUSPENDED (job swapping, use case 2) and RESTARTING (recovery in progress).

Port of ``repro/core/coordinator.py``.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.ckpt.plane import DataPlaneConfig
from repro_torch.ckpt.storage import ObjectStore
from repro_torch.clusters.base import VMHandle, VMTemplate
from repro_torch.clusters.simulator import fresh_id
from repro_torch.obs.telemetry import registry
from repro_torch.sim.simtime import active_clock


class _CoordMetrics(dict):
    """Coordinator metrics dict with registry write-through.

    Drop-in for the plain dict it replaces (same reads, same
    ``to_dict()`` serialization). Once bound to the job's deterministic
    trace_id (``CoordinatorDB`` binds at create/load), numeric writes are
    mirrored as registry gauges ``coord.<trace_id>.<key>`` so per-job
    RPO/MTTR/queue-wait numbers appear in one telemetry snapshot without
    any new accessor; non-numeric values stay dict-only.
    """

    _label = ""

    def bind(self, label: str) -> "_CoordMetrics":
        self._label = label
        for k, v in self.items():              # back-fill pre-bind writes
            self._mirror(k, v)
        return self

    def _mirror(self, key: str, value: Any) -> None:
        if (self._label and isinstance(value, (int, float))
                and not isinstance(value, bool)):
            registry().set_gauge(f"coord.{self._label}.{key}", float(value))

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, value)
        self._mirror(key, value)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self:
            self[key] = default
            return default
        return self[key]

    def update(self, *args: Any, **kwargs: Any) -> None:
        for k, v in dict(*args, **kwargs).items():
            self[k] = v


class CoordState(enum.Enum):
    CREATING = "CREATING"
    QUEUED = "QUEUED"                # admitted but waiting for capacity
    PROVISIONING = "PROVISIONING"
    READY = "READY"
    RUNNING = "RUNNING"
    SUSPENDED = "SUSPENDED"          # swapped out to stable storage
    RESTARTING = "RESTARTING"
    TERMINATING = "TERMINATING"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"


# Legal transitions (paper Fig 2 + swapping/recovery extensions).
TRANSITIONS: Dict[CoordState, tuple] = {
    CoordState.CREATING: (CoordState.QUEUED, CoordState.PROVISIONING,
                          CoordState.ERROR, CoordState.TERMINATING),
    # QUEUED is a persisted record with no resources: the GlobalScheduler
    # owns when its bring-up (-> PROVISIONING) or image restart
    # (-> RESTARTING, for requeued jobs that already hold images) starts,
    # so queued work survives a service restart (paper §6.4).
    CoordState.QUEUED: (CoordState.PROVISIONING, CoordState.RESTARTING,
                        CoordState.ERROR, CoordState.TERMINATING),
    CoordState.PROVISIONING: (CoordState.READY, CoordState.ERROR,
                              CoordState.TERMINATING),
    CoordState.READY: (CoordState.RUNNING, CoordState.ERROR,
                       CoordState.TERMINATING),
    CoordState.RUNNING: (CoordState.SUSPENDED, CoordState.RESTARTING,
                         CoordState.TERMINATING, CoordState.ERROR),
    CoordState.SUSPENDED: (CoordState.RESTARTING, CoordState.TERMINATING,
                           CoordState.ERROR),
    # RESTARTING -> SUSPENDED: a resume aborted before any VM was claimed
    # (capacity raced away) falls back to stable storage, not ERROR.
    CoordState.RESTARTING: (CoordState.RUNNING, CoordState.SUSPENDED,
                            CoordState.ERROR, CoordState.TERMINATING),
    CoordState.TERMINATING: (CoordState.TERMINATED, CoordState.ERROR),
    CoordState.TERMINATED: (),
    # ERROR -> QUEUED: the scheduler requeues a job whose whole cloud died
    # (recovery exhausted at home); it waits for a warm standby or a heal.
    CoordState.ERROR: (CoordState.TERMINATING, CoordState.RESTARTING,
                       CoordState.QUEUED),
}


@dataclasses.dataclass
class CheckpointPolicy:
    period_s: float = 0.0            # 0 = no periodic checkpoints
    codec: str = "raw"
    keep_last: int = 3
    keep_every: int = 0
    store: str = "default"           # named storage backend
    # Codec for *swap-out* images (suspend/preemption). A preempted job's
    # image is written once and read once, so a lossy codec ("int8":
    # device-side qsnap encode, ~4x fewer device-exit bytes) is often
    # acceptable there while periodic images stay lossless for exact
    # restarts. None = use ``codec`` for swap-outs too.
    swap_codec: Optional[str] = None
    # per-app override of the checkpoint data-plane parallelism (worker
    # counts, in-flight byte cap); None = the CheckpointManager's default
    plane: Optional[DataPlaneConfig] = None


@dataclasses.dataclass
class ASR:
    """Application Submission Request (paper §5.1)."""
    name: str
    n_vms: int
    backend: str                     # cloud backend name
    app_factory: Callable[[], Any]   # () -> Application
    template: VMTemplate = dataclasses.field(default_factory=VMTemplate)
    policy: CheckpointPolicy = dataclasses.field(
        default_factory=CheckpointPolicy)
    priority: int = 0                # higher preempts lower
    # backends this job may run on (cloud-spanning placement / backfill
    # stays inside the list); empty = any registered backend. ``backend``
    # above is the *home* cloud — the placement scorer's affinity target.
    clouds: tuple = ()
    provision_cmds: tuple = ()       # user-defined provisioning hooks
    health_hook: Optional[Callable[[], bool]] = None
    # Gang job: the application is an N-rank distributed computation whose
    # snapshots must be gang-consistent (core/gang.py barrier protocol).
    # Placement is all-or-nothing: the scheduler never starts a gang on
    # fewer than min_vms ranks, and only shrinks below n_vms when the job
    # already holds a gang image to reshard from (elastic shrink-restore).
    gang: bool = False
    min_vms: int = 0                 # 0 = full n_vms required
    # What the monitor does when it detects a straggling host (paper use
    # case 3): "suspend" proactively swaps the job out; "ignore" leaves
    # handling to the application — gang jobs often prefer "ignore" so the
    # barrier's own straggler abort isn't raced by a concurrent swap-out.
    straggler_action: str = "suspend"


@dataclasses.dataclass
class Coordinator:
    coord_id: str
    asr: ASR
    state: CoordState = CoordState.CREATING
    vms: List[VMHandle] = dataclasses.field(default_factory=list)
    app: Any = None                          # live Application (not persisted)
    history: List[tuple] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    created_at: float = dataclasses.field(
        default_factory=lambda: active_clock().timestamp())
    metrics: Dict[str, float] = dataclasses.field(
        default_factory=_CoordMetrics)
    recoveries: int = 0
    # Failover targets restore from the *primary's* replicated prefix
    # (core/replication.py): overriding the prefix lets a standby
    # coordinator adopt an already-replicated image lineage with zero
    # chunk copies, and continue appending to it after failover.
    ckpt_prefix_override: Optional[str] = None
    # Seed-lineage adoption for serving-fleet scale-out (serve/fleet.py):
    # unlike ckpt_prefix_override (which rehomes the job's whole lineage),
    # an adopt prefix only redirects *reads while this job's own prefix
    # holds no committed image* — the replica cold-starts from the shared
    # seed image with zero chunk copies, then its own suspend/periodic
    # saves start a private lineage under ckpt_prefix (many replicas can
    # adopt one seed without their saves colliding).
    ckpt_adopt_prefix: Optional[str] = None
    # Per-job trace id threaded through every control-plane record touching
    # this job (scheduler decision_trace rows, chaos outcomes, replication
    # stats) so one gang lifecycle is debuggable from a single grep. It is
    # DETERMINISTIC — derived from the DB's creation sequence, not a uuid —
    # because seeded chaos tests compare traces across replays for
    # bit-for-bit equality.
    trace_id: str = ""
    lock: threading.RLock = dataclasses.field(default_factory=threading.RLock,
                                              repr=False)

    @property
    def ckpt_prefix(self) -> str:
        return self.ckpt_prefix_override or f"apps/{self.coord_id}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.coord_id,
            "name": self.asr.name,
            "trace_id": self.trace_id,
            "state": self.state.value,
            "backend": self.asr.backend,
            "n_vms": self.asr.n_vms,
            "gang": self.asr.gang,
            "min_vms": self.asr.min_vms,
            "vms": [vm.vm_id for vm in self.vms],
            "priority": self.asr.priority,
            "clouds": list(self.asr.clouds),
            "error": self.error,
            "recoveries": self.recoveries,
            "history": [(t, s) for t, s, *_ in self.history],
            "ckpt_prefix": self.ckpt_prefix,
            "ckpt_adopt_prefix": self.ckpt_adopt_prefix,
            "policy": {
                "period_s": self.asr.policy.period_s,
                "codec": self.asr.policy.codec,
                "keep_last": self.asr.policy.keep_last,
                "keep_every": self.asr.policy.keep_every,
                "store": self.asr.policy.store,
            },
            "metrics": {k: v for k, v in self.metrics.items()
                        if isinstance(v, (int, float, str))},
        }


def _unrehydratable_app() -> Any:
    raise RuntimeError(
        "coordinator was rehydrated from its persisted record and has no "
        "live application factory (code is not persisted); assign "
        "coord.asr.app_factory before restarting it")


class CoordinatorDB:
    """Thread-safe coordinator database with ObjectStore persistence.

    The paper keeps it in memory (§6.5) and notes it "could be implemented
    relying on a NoSQL reliable distributed database" (§6.4) — persistence
    to the reliable object store gives managers the same restartability:
    ``load()`` is the read path, rehydrating records (sans live app/VMs)
    from ``db/coordinators/*.json`` so a restarted service instance sees
    its coordinators again and can restart them from their images.
    """

    def __init__(self, store: Optional[ObjectStore] = None):
        self._lock = threading.RLock()
        self._coords: Dict[str, Coordinator] = {}
        self._store = store
        self._created = 0            # trace_id sequence (deterministic)

    def load(self) -> List[Coordinator]:
        """Rehydrate persisted coordinator records from the object store.

        Live state (the Application instance, VM handles) is process-bound
        and not persisted — rehydrated coordinators come back with
        ``app=None`` / ``vms=[]`` and an ``app_factory`` placeholder that
        raises until re-attached; their checkpoint images, step history
        and state survive, so ``restart_from`` (after re-attaching a
        factory) resumes them on a fresh cluster. Records already present
        in memory are left untouched. Returns the rehydrated coordinators.
        """
        if self._store is None:
            return []
        loaded: List[Coordinator] = []
        for key in self._store.list("db/coordinators/"):
            d = json.loads(self._store.get(key).decode())
            with self._lock:
                if d["id"] in self._coords:
                    continue
            pol = d.get("policy", {})
            asr = ASR(name=d["name"], n_vms=d["n_vms"], backend=d["backend"],
                      app_factory=_unrehydratable_app,
                      policy=CheckpointPolicy(
                          period_s=pol.get("period_s", 0.0),
                          codec=pol.get("codec", "raw"),
                          keep_last=pol.get("keep_last", 3),
                          keep_every=pol.get("keep_every", 0),
                          store=pol.get("store", "default")),
                      priority=d.get("priority", 0),
                      clouds=tuple(d.get("clouds", ())),
                      gang=d.get("gang", False),
                      min_vms=d.get("min_vms", 0))
            coord = Coordinator(
                coord_id=d["id"], asr=asr,
                state=CoordState(d["state"]),
                history=[(t, s) for t, s in d.get("history", [])],
                error=d.get("error"),
                recoveries=d.get("recoveries", 0),
                metrics=_CoordMetrics(d.get("metrics", {})),
                trace_id=d.get("trace_id", ""))
            coord.metrics.bind(coord.trace_id)
            prefix = d.get("ckpt_prefix")
            if prefix and prefix != f"apps/{coord.coord_id}":
                coord.ckpt_prefix_override = prefix
            coord.ckpt_adopt_prefix = d.get("ckpt_adopt_prefix")
            with self._lock:
                self._coords[coord.coord_id] = coord
            loaded.append(coord)
        return loaded

    def create(self, asr: ASR) -> Coordinator:
        coord = Coordinator(coord_id=fresh_id("coord"), asr=asr)
        coord.history.append((active_clock().timestamp(), coord.state.value))
        with self._lock:
            # trace_id is a pure function of (submission order, job name) so
            # a replayed seeded scenario produces byte-identical traces
            coord.trace_id = f"tr-{asr.name}-{self._created:04d}"
            self._created += 1
            if isinstance(coord.metrics, _CoordMetrics):
                coord.metrics.bind(coord.trace_id)
            self._coords[coord.coord_id] = coord
        self._persist(coord)
        return coord

    def get(self, coord_id: str) -> Coordinator:
        with self._lock:
            if coord_id not in self._coords:
                raise KeyError(f"unknown coordinator {coord_id}")
            return self._coords[coord_id]

    def list(self) -> List[Coordinator]:
        with self._lock:
            return list(self._coords.values())

    def remove(self, coord_id: str) -> None:
        with self._lock:
            self._coords.pop(coord_id, None)
        if self._store is not None:
            self._store.delete(f"db/coordinators/{coord_id}.json")

    def transition(self, coord: Coordinator, new: CoordState,
                   reason: str = "") -> None:
        with coord.lock:
            if new not in TRANSITIONS[coord.state]:
                raise InvalidTransition(
                    f"{coord.coord_id}: {coord.state.value} -> {new.value}")
            coord.state = new
            coord.history.append((active_clock().timestamp(), new.value, reason))
        self._persist(coord)

    def persist(self, coord: Coordinator) -> None:
        """Re-write a coordinator's persisted record outside a transition —
        for metadata that must survive a restart, like the scheduler's
        queue-entry stamp (aging restarts from the persisted wait)."""
        self._persist(coord)

    def _persist(self, coord: Coordinator) -> None:
        if self._store is not None:
            self._store.put(f"db/coordinators/{coord.coord_id}.json",
                            json.dumps(coord.to_dict()).encode())


class InvalidTransition(RuntimeError):
    pass
