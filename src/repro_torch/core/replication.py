"""Cross-cloud checkpoint replication & standby failover.

The paper's headline capability is that a cloud-agnostic checkpoint
service enables "migration of applications from one cloud platform to
another" (§5.3, §7.3) — but on-demand migration is *cold*: the full image
crosses the inter-cloud link at migration time, and ``transfer_s``
dominates exactly as in the paper's Table 3. This module keeps standby
clouds continuously warm instead:

  * :class:`ReplicationPolicy` — per-app replication contract: which
    standby targets to keep warm, the lag budget (RPO target) and an
    optional bandwidth cap on replication traffic.
  * :class:`ImageReplicator`  — an asynchronous daemon that watches every
    newly COMMITTED image of a watched app and ships only the chunks the
    standby store is missing (content-addressed dedup via the CAS digests),
    through the parallel data plane's upload streams with ``ByteBudget``
    backpressure. Replication repeats the writer's commit protocol on the
    standby — chunks, then manifest, then COMMITTED — so a standby reader
    only ever sees *fully replicated* images, and tracks per-target
    replication lag / RPO (``replication_stats``).
  * :class:`FailoverController` — pairs a primary :class:`CACSService`
    with standby services: when the primary's cloud suffers a whole-cloud
    outage (``ClusterSim.cloud_outage`` / the ``cloud_outage`` chaos
    event), it restarts the job on the best standby from the newest fully
    replicated image — with **zero chunk re-uploads**, because the standby
    coordinator adopts the replicated prefix — and records failover MTTR.

Warm migration falls out of the same substrate: ``migration.clone`` /
``migrate`` transfer through ``CheckpointManager.upload_image``, which
sources any chunk already replicated to the destination side from the
local replica instead of the inter-cloud link, so ``transfer_s`` collapses
to the unreplicated delta (``benchmarks/replication.py`` measures both
economics; Spot-on, arXiv:2210.02589, takes the same direction for
preemptible capacity).

Note the failure model: an outage takes the primary *compute* down; the
primary object store may or may not survive it. Failover never depends on
the primary store — the standby restores purely from its own replica —
but post-failover RPO accounting reads the primary store opportunistically
when it is still reachable.

Port of ``repro/core/replication.py``. The scenario reads the restored
image back onto the device the standby application declares
(``app.device``, as ``CheckpointManager.load`` does), never onto the host
by default; ``SimulatedApp`` declares the CPU.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.ckpt import gc as ckpt_gc
from repro_torch.ckpt.layout import COMMITTED, MANIFEST, step_prefix
from repro_torch.ckpt.plane import ByteBudget, DataPlaneConfig, shared_executor
from repro_torch.ckpt.reader import list_steps, load_manifest
from repro_torch.ckpt.storage import ObjectStore
from repro_torch.obs.telemetry import registry
from repro_torch.obs.trace import tracer
from repro_torch.sim.simtime import active_clock
from repro_torch.core.coordinator import Coordinator, CoordState


@dataclasses.dataclass(frozen=True)
class ReplicationPolicy:
    """Per-application replication contract.

    targets:        names of registered :class:`StandbyTarget`\\ s to keep
                    warm (replication fans out to all of them).
    lag_budget_s:   RPO target — the newest fully replicated image should
                    be at most this many seconds behind the newest
                    committed primary image (reported, not enforced:
                    ``replication_stats`` flags budget violations).
    bandwidth_bps:  optional cap on replication throughput per app
                    (cross-cloud egress is metered; background replication
                    must not starve the foreground save path).
    prune_with_primary: mirror primary GC — drop standby steps the primary
                    retention policy already deleted, sweeping orphaned
                    replica chunks, so standby storage stays bounded.
    """
    targets: Tuple[str, ...]
    lag_budget_s: float = 30.0
    bandwidth_bps: Optional[float] = None
    prune_with_primary: bool = True


@dataclasses.dataclass
class StandbyTarget:
    """A standby cloud: its object store, plus (for failover) the service
    instance running there and the backend/size to restart onto."""
    name: str
    store: ObjectStore
    service: Any = None                   # standby CACSService (failover)
    backend: Optional[str] = None         # backend name on that service
    n_vms: Optional[int] = None           # standby cluster size override


class _Throttle:
    """Leaky-bucket bytes/sec limiter shared by one app's copy streams.

    ``debit`` reserves the caller's slot under a lock and sleeps outside
    it, so parallel streams stay parallel while their *aggregate* rate
    converges on ``bps``. No-op when uncapped.
    """

    def __init__(self, bps: Optional[float]):
        self.bps = bps
        self._lock = threading.Lock()
        self._next_free = active_clock().now()

    def debit(self, nbytes: int) -> None:
        if not self.bps:
            return
        clk = active_clock()
        with self._lock:
            now = clk.now()
            # nbytes/bps is a wall-tuned duration; map it onto the clock's
            # native axis so the aggregate rate is preserved virtually
            start = max(self._next_free, now)
            self._next_free = start + clk.from_wall(nbytes / self.bps)
            # the chunk occupies the link for nbytes/bps: wait for our own
            # transfer slot to finish, not just for the link to free up —
            # otherwise a single large chunk would never be throttled
            delay = self._next_free - now
        if delay > 0:
            clk.sleep_until(now + delay)


def _pair_state() -> Dict[str, Any]:
    return {"last_step": None, "last_image_time": None,
            "images_replicated": 0, "chunks_copied": 0, "bytes_copied": 0,
            "chunks_skipped": 0, "bytes_skipped": 0, "steps_pruned": 0,
            "errors": 0}


class ImageReplicator:
    """Asynchronous continuous image replication to standby clouds.

    Watches the primary service's committed images per registered app and
    ships each new image to every target in the app's policy. Per image,
    only chunks the standby store does not already hold cross the link
    (CAS-digest dedup — across steps *and* across apps sharing content);
    copies fan out over the data plane's upload workers under a
    ``ByteBudget`` in-flight cap and the policy's bandwidth throttle, and
    the standby-side commit order (chunks → manifest → flush → COMMITTED)
    guarantees standbys only ever expose fully replicated images.
    """

    def __init__(self, service, *, plane: Optional[DataPlaneConfig] = None,
                 tick_s: float = 0.02):
        self.service = service
        self.plane = plane or DataPlaneConfig()
        self.tick_s = tick_s
        self._targets: Dict[str, StandbyTarget] = {}
        self._watched: Dict[str, ReplicationPolicy] = {}
        self._throttles: Dict[str, _Throttle] = {}
        self._pairs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._replicated_listeners: List[Any] = []
        self._lock = threading.RLock()
        self._sync_lock = threading.Lock()    # one sync pass at a time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._budget = ByteBudget(self.plane.max_inflight_bytes,
                                  name="replication")
        self.images_replicated = 0
        self.sync_errors = 0

    # ---- registration --------------------------------------------------
    def add_target(self, target: StandbyTarget) -> None:
        with self._lock:
            self._targets[target.name] = target

    def target(self, name: str) -> StandbyTarget:
        with self._lock:
            if name not in self._targets:
                raise KeyError(f"unknown replication target {name!r}; "
                               f"have {sorted(self._targets)}")
            return self._targets[name]

    def watch(self, coord_id: str, policy: ReplicationPolicy) -> None:
        for name in policy.targets:
            self.target(name)                 # fail fast on a typo
        with self._lock:
            self._watched[coord_id] = policy
            self._throttles[coord_id] = _Throttle(policy.bandwidth_bps)
            for name in policy.targets:
                self._pairs.setdefault((coord_id, name), _pair_state())

    def unwatch(self, coord_id: str) -> None:
        with self._lock:
            self._watched.pop(coord_id, None)
            self._throttles.pop(coord_id, None)

    def watched(self) -> List[str]:
        with self._lock:
            return list(self._watched)

    def on_replicated(self, cb) -> None:
        """Subscribe to replication completions: ``cb(coord_id, target,
        step)`` fires after an image is fully COMMITTED on a standby.
        The GlobalScheduler keys cross-cloud backfill warmth on this —
        a job waiting for its replica becomes placeable the instant the
        replica commits, event-driven instead of polled."""
        self._replicated_listeners.append(cb)

    # ---- daemon --------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="replicator")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not active_clock().wait(self._stop, self.tick_s):
            try:
                self.sync()
            except Exception as e:             # noqa: BLE001
                # one bad pass (e.g. a coord terminated mid-walk) must not
                # kill replication for every app; retried next tick
                with self._lock:
                    self.sync_errors += 1
                registry().inc("replication.daemon_errors",
                               note=f"{type(e).__name__}: {e}")

    # ---- replication ---------------------------------------------------
    def sync(self, coord_id: Optional[str] = None) -> None:
        """Replicate every pending committed image now (blocking until the
        current backlog drains). The daemon calls this each tick; tests,
        benchmarks and pre-failover drains call it directly."""
        with self._sync_lock:
            with self._lock:
                work = ([(coord_id, self._watched[coord_id])]
                        if coord_id is not None
                        else list(self._watched.items()))
            for cid, policy in work:
                try:
                    coord = self.service.db.get(cid)
                except KeyError:
                    self.unwatch(cid)          # terminated: stop replicating
                    continue
                for name in policy.targets:
                    try:
                        self._sync_pair(coord, policy, self.target(name))
                    except Exception as e:     # noqa: BLE001
                        with self._lock:
                            self._pairs[(cid, name)]["errors"] += 1
                            self.sync_errors += 1
                        registry().inc("replication.daemon_errors",
                                       note=f"{type(e).__name__}: {e}")

    def _sync_pair(self, coord: Coordinator, policy: ReplicationPolicy,
                   target: StandbyTarget) -> None:
        src = self.service.ckpt.store(coord.asr.policy.store)
        prefix = coord.ckpt_prefix
        src_steps = list_steps(src, prefix)
        dst_steps = set(list_steps(target.store, prefix))
        state = self._pairs[(coord.coord_id, target.name)]
        for s in src_steps:
            if s not in dst_steps:
                self._replicate_image(coord, target, src, prefix, s, state)
        if policy.prune_with_primary:
            stale = sorted(dst_steps - set(src_steps))
            for s in stale:
                target.store.delete_prefix(step_prefix(prefix, s))
                state["steps_pruned"] += 1
            if stale:
                ckpt_gc.sweep_orphans(target.store, prefix)
        # RPO bookkeeping on the coordinator itself (service dashboards)
        lag = self._lag(src, prefix, state)
        coord.metrics[f"replication_lag_s:{target.name}"] = lag

    def _replicate_image(self, coord: Coordinator, target: StandbyTarget,
                         src: ObjectStore, prefix: str, step: int,
                         state: Dict[str, Any]) -> None:
        with tracer().span("replication/ship", cat="replication",
                           trace_id=coord.trace_id,
                           args={"step": step, "target": target.name}) as span:
            self._replicate_image_inner(coord, target, src, prefix, step,
                                        state, span)

    def _replicate_image_inner(self, coord: Coordinator,
                               target: StandbyTarget, src: ObjectStore,
                               prefix: str, step: int,
                               state: Dict[str, Any], span) -> None:
        man = load_manifest(src, prefix, step)
        dst = target.store
        throttle = self._throttles.get(coord.coord_id) or _Throttle(None)
        unique = {c.key: c for li in man.leaves.values() for c in li.chunks}
        missing = []
        for key, c in unique.items():
            if dst.exists(key):                # already shipped (dedup)
                state["chunks_skipped"] += 1
                state["bytes_skipped"] += c.nbytes
            else:
                missing.append(c)

        def ship(c) -> None:
            self._budget.acquire(c.nbytes)
            try:
                data = src.get(c.key)
                throttle.debit(len(data))
                if dst.put_if_absent(c.key, data):
                    state["chunks_copied"] += 1
                    state["bytes_copied"] += len(data)
                else:                          # raced another lineage
                    state["chunks_skipped"] += 1
                    state["bytes_skipped"] += len(data)
            finally:
                self._budget.release(c.nbytes)

        workers = max(1, self.plane.upload_workers)
        if workers == 1 or len(missing) <= 1:
            for c in missing:
                ship(c)
        else:
            ex = shared_executor("up", workers)
            for fut in [ex.submit(ship, c) for c in missing]:
                fut.result()                   # join: every chunk durable
        # standby-side commit, exactly like the writer: manifest after all
        # chunks, COMMITTED after the manifest — a crash mid-replication
        # leaves an invisible partial image that the next pass completes
        sp = step_prefix(prefix, step)
        gang = man.metadata.get("gang")
        if gang:                               # per-rank sub-manifests ride
            for r in range(int(gang.get("ranks", 0))):   # along (diagnostic)
                try:
                    dst.put(f"{sp}/rank_{r}.json",
                            src.get(f"{sp}/rank_{r}.json"))
                except Exception:              # noqa: BLE001
                    pass                       # restore needs only the merge
        dst.put(f"{sp}/{MANIFEST}", src.get(f"{sp}/{MANIFEST}"))
        dst.flush()
        dst.put(f"{sp}/{COMMITTED}", b"1")
        dst.flush()
        state["last_step"] = step
        state["last_image_time"] = man.metadata.get("time")
        state["images_replicated"] += 1
        span.set("chunks_copied", len(missing))
        registry().inc("replication.images")
        with self._lock:
            self.images_replicated += 1
            listeners = list(self._replicated_listeners)
        for cb in listeners:
            try:
                cb(coord.coord_id, target.name, step)
            except Exception:              # noqa: BLE001
                pass                       # a bad listener must not stall sync

    # ---- queries -------------------------------------------------------
    def _lag(self, src: ObjectStore, prefix: str,
             state: Dict[str, Any]) -> float:
        """RPO in seconds: commit-time gap between the newest primary image
        and the newest fully replicated one (0 when in sync, inf when
        nothing has replicated yet)."""
        steps = list_steps(src, prefix)
        newest = steps[-1] if steps else None
        if newest is None or newest == state["last_step"]:
            return 0.0
        if state["last_image_time"] is None:
            return float("inf")
        t_new = load_manifest(src, prefix, newest).metadata.get("time")
        if t_new is None:
            return float("inf")
        return max(0.0, t_new - state["last_image_time"])

    def replication_stats(self, coord_id: str) -> Dict[str, Any]:
        """Per-target replication state for one app: last fully replicated
        step, image/second lag vs the newest primary image, budget
        compliance, and cumulative copy/skip counters."""
        with self._lock:
            policy = self._watched.get(coord_id)
        if policy is None:
            return {}
        coord = self.service.db.get(coord_id)
        src = self.service.ckpt.store(coord.asr.policy.store)
        prefix = coord.ckpt_prefix
        src_steps = list_steps(src, prefix)
        targets: Dict[str, Any] = {}
        for name in policy.targets:
            state = self._pairs[(coord_id, name)]
            last = state["last_step"]
            lag_images = len([s for s in src_steps
                              if last is None or s > last])
            rpo_s = self._lag(src, prefix, state)
            targets[name] = {
                **{k: v for k, v in state.items() if k != "last_image_time"},
                "lag_images": lag_images,
                "rpo_s": rpo_s,
                "within_budget": rpo_s <= policy.lag_budget_s,
            }
        return {"coord": coord_id,
                "trace_id": coord.trace_id,
                "policy": {"lag_budget_s": policy.lag_budget_s,
                           "bandwidth_bps": policy.bandwidth_bps,
                           "targets": list(policy.targets)},
                "targets": targets}

    def best_standby(self, coord_id: str
                     ) -> Tuple[Optional[StandbyTarget], Optional[int]]:
        """The standby holding the newest *fully replicated* (COMMITTED on
        the standby) image, and that step. Consults the standby stores
        directly — the primary store may already be unreachable."""
        with self._lock:
            policy = self._watched.get(coord_id)
        if policy is None:
            return None, None
        prefix = self.service.db.get(coord_id).ckpt_prefix
        best: Tuple[Optional[StandbyTarget], Optional[int]] = (None, None)
        for name in policy.targets:
            target = self.target(name)
            steps = list_steps(target.store, prefix)
            if steps and (best[1] is None or steps[-1] > best[1]):
                best = (target, steps[-1])
        return best


@dataclasses.dataclass
class FailoverResult:
    """One completed (or failed) cross-cloud failover."""
    src_id: str
    dst_id: Optional[str]
    target: Optional[str]                 # standby target name
    step: Optional[int]                   # image the standby restored from
    detection_s: Optional[float]          # primary RUNNING -> ERROR
    restart_s: Optional[float]            # failover start -> standby RUNNING
    mttr_s: Optional[float]               # primary ERROR -> standby RUNNING
    rpo_images: Optional[int]             # primary images newer than `step`
    chunks_reuploaded: int                # CAS objects written on the
                                          # standby during failover (== 0:
                                          # all content was pre-replicated)
    ok: bool = True
    error: Optional[str] = None
    # replication_stats snapshot taken at failover-decision time, pairing
    # each MTTR/RPO with the lag that produced it
    replication: Optional[Dict[str, Any]] = None


class FailoverController:
    """Detects the loss of a whole primary cloud and restarts the affected
    jobs on the best standby.

    Trigger (the watch loop): a replicated coordinator sits in ERROR, its
    old fleet is fully unreachable, and its backend reports zero capacity
    — i.e. recovery on the home cloud has conclusively failed *and* the
    cloud itself is gone (a plain VM crash never trips this: recovery
    replaces the VM long before ERROR). ``failover()`` can also be driven
    explicitly (operator-initiated evacuation).

    The standby coordinator adopts the primary's replicated checkpoint
    prefix (``Coordinator.ckpt_prefix_override``), so the restart reads
    chunks the replicator already shipped — zero re-uploads — and
    post-failover saves continue the same lineage on the standby store.
    """

    def __init__(self, primary, replicator: ImageReplicator, *,
                 poll_interval_s: float = 0.02,
                 retire_primary: bool = True,
                 restart_timeout_s: float = 60.0):
        self.primary = primary
        self.replicator = replicator
        self.poll_interval_s = poll_interval_s
        self.retire_primary = retire_primary
        self.restart_timeout_s = restart_timeout_s
        self.results: Dict[str, FailoverResult] = {}
        self.failovers = 0
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- daemon --------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="failover")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not active_clock().wait(self._stop, self.poll_interval_s):
            for coord_id in self.replicator.watched():
                with self._lock:
                    if coord_id in self.results or coord_id in self._inflight:
                        continue
                try:
                    coord = self.primary.db.get(coord_id)
                except KeyError:
                    continue
                if self._cloud_down(coord):
                    try:
                        self.failover(coord_id)
                    except Exception as e:     # noqa: BLE001
                        with self._lock:
                            self.results[coord_id] = FailoverResult(
                                src_id=coord_id, dst_id=None, target=None,
                                step=None, detection_s=None, restart_s=None,
                                mttr_s=None, rpo_images=None,
                                chunks_reuploaded=0, ok=False, error=str(e))

    def _cloud_down(self, coord: Coordinator) -> bool:
        """Conclusive home-cloud loss: the job sits in ERROR (recovery
        exhausted), its fleet is dark (both the stale VM handles and the
        monitor's sticky whole-fleet-unreachable flag agree), the backend
        reports zero spare capacity, and no *other* coordinator of this
        service is demonstrably alive on the same backend. A healthy-but-
        full cloud with live peers therefore never trips this; with no
        peers to observe, ERROR + zero capacity is indistinguishable from
        an outage — and the job cannot run at home either way, so failing
        over is the availability-preserving choice."""
        if coord.state != CoordState.ERROR:
            return False
        if coord.vms and any(vm.reachable for vm in coord.vms):
            return False
        monitor = self.primary.apps.monitor
        if not monitor.fleet_unreachable(coord.coord_id):
            return False                       # e.g. ERROR from an app bug
        try:
            backend = self.primary.cloud.backend(coord.asr.backend)
            if backend.capacity() > 0:
                return False                   # the cloud can still recover
        except Exception:                      # noqa: BLE001
            pass                               # unreachable backend == down
        for peer in self.primary.db.list():
            if (peer.coord_id != coord.coord_id
                    and peer.asr.backend == coord.asr.backend
                    and peer.state == CoordState.RUNNING
                    and any(vm.reachable for vm in peer.vms)):
                return False                   # the cloud is alive, just full
        return True

    # ---- the failover itself -------------------------------------------
    def failover(self, coord_id: str) -> FailoverResult:
        # exactly-once per coordinator: an explicit (operator) call racing
        # the watch loop waits for the in-flight failover instead of
        # starting a second one — two standby restarts of the same job
        # would be a split brain
        while True:
            with self._lock:
                if coord_id in self.results:
                    return self.results[coord_id]
                if coord_id not in self._inflight:
                    self._inflight.add(coord_id)
                    break
            active_clock().sleep(0.002)
        try:
            result = self._failover(coord_id)
        finally:
            with self._lock:
                self._inflight.discard(coord_id)
        with self._lock:
            self.results[coord_id] = result
            self.failovers += 1
        return result

    def _failover(self, coord_id: str) -> FailoverResult:
        coord = self.primary.db.get(coord_id)
        t_error = self._last_transition(coord, "ERROR")
        t_down = self._last_transition(coord, "RESTARTING")
        t0 = active_clock().timestamp()
        try:
            repl_snapshot = self.replicator.replication_stats(coord_id)
        except Exception:                      # noqa: BLE001
            repl_snapshot = None               # primary store unreachable
        target, step = self.replicator.best_standby(coord_id)
        if target is None or step is None:
            raise RuntimeError(
                f"{coord_id}: no standby holds a fully replicated image")
        if target.service is None or target.backend is None:
            raise RuntimeError(
                f"standby {target.name!r} has no service/backend attached")
        prefix = coord.ckpt_prefix
        # the zero-reupload invariant, measured against the restored image
        # itself: chunks of that manifest NOT already on the standby are
        # what the failover would have to ship (0 == fully pre-replicated).
        # Deliberately not a before/after CAS count — the standby app
        # resumes periodic saves the instant it is RUNNING, which would
        # race new (unrelated) chunks into such a delta.
        man = load_manifest(target.store, prefix, step)
        chunk_keys = {c.key for li in man.leaves.values() for c in li.chunks}
        reuploads = sum(1 for k in chunk_keys
                        if not target.store.exists(k))

        dst = target.service
        new_asr = dataclasses.replace(
            coord.asr, backend=target.backend,
            n_vms=target.n_vms or coord.asr.n_vms)
        dst_coord = dst.db.create(new_asr)
        dst_coord.ckpt_prefix_override = prefix     # adopt the replica
        dst.restart_from(dst_coord.coord_id, step)
        dst.wait_for_state(dst_coord.coord_id, CoordState.RUNNING,
                           timeout=self.restart_timeout_s)
        t_up = active_clock().timestamp()

        rpo_images = self._rpo_images(coord, step)
        detection = (None if t_error is None or t_down is None
                     else max(0.0, t_error - t_down))
        mttr = None if t_error is None else max(0.0, t_up - t_error)
        result = FailoverResult(
            src_id=coord_id, dst_id=dst_coord.coord_id, target=target.name,
            step=step, detection_s=detection, restart_s=t_up - t0,
            mttr_s=mttr, rpo_images=rpo_images,
            chunks_reuploaded=reuploads,
            replication=repl_snapshot)
        coord.metrics["failover_mttr_s"] = mttr if mttr is not None else -1.0
        coord.metrics["failover_target"] = target.name
        dst_coord.metrics["failover_src"] = coord_id
        # the primary lineage is handed over: stop replicating it, and
        # (optionally) retire the dead coordinator without deleting its
        # images — the standby owns the lineage now, and the primary store
        # copy (if it survived the outage) remains a valid replica
        self.replicator.unwatch(coord_id)
        if self.retire_primary:
            try:
                self.primary.apps.terminate(coord_id, delete_images=False)
            except Exception:                  # noqa: BLE001
                pass                           # the cloud is down; best-effort
        return result

    @staticmethod
    def _last_transition(coord: Coordinator, state: str) -> Optional[float]:
        for t, s, *_ in reversed(coord.history):
            if s == state:
                return t
        return None

    def _rpo_images(self, coord: Coordinator, step: int) -> Optional[int]:
        """Primary images newer than the restored one — best-effort: the
        primary store may have died with the cloud."""
        try:
            store = self.primary.ckpt.store(coord.asr.policy.store)
            return len([s for s in list_steps(store, coord.ckpt_prefix)
                        if s > step])
        except Exception:                      # noqa: BLE001
            return None


# ---------------------------------------------------------------------------
# Seeded end-to-end scenario (failover smoke / benchmark / example substrate)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailoverScenarioResult:
    seed: int
    outage_at_s: float
    failover: FailoverResult
    primary_final_state: str
    standby_state: str
    restored_iteration: int               # iteration in the restored image
    primary_iteration: int                # where the primary actually was
    replication: Dict[str, Any]           # stats snapshot at outage time
    trace: List[Tuple]

    @property
    def iterations_lost(self) -> int:
        return max(0, self.primary_iteration - self.restored_iteration)


def run_failover_scenario(seed: int = 11, *, n_hosts: int = 8,
                          n_vms: int = 2, outage_at_s: float = 6.0,
                          period_s: float = 0.4, iter_time_s: float = 0.2,
                          state_mb: float = 0.05,
                          bandwidth_bps: Optional[float] = None,
                          continuous_replication: bool = True,
                          settle_timeout_s: float = 60.0
                          ) -> FailoverScenarioResult:
    """Primary + standby services on two simulated clouds with separate
    stores; continuous replication; a seeded whole-cloud outage of the
    primary; automatic failover to the standby. Deterministic in outcome
    from the seed (same trace contract as ``chaos.run_scenario``).

    continuous_replication=False stops replicating after the initial
    image — the lag then grows with every periodic save, so the failover
    measures a large-RPO restore (the MTTR-vs-lag axis of
    ``benchmarks/replication.py``).
    """
    from repro_torch.ckpt.storage import InMemoryStore
    from repro_torch.clusters import OpenStackBackend, SnoozeBackend
    from repro_torch.core.application import SimulatedApp
    from repro_torch.core.chaos import (ChaosController, FaultEvent,
                                        FaultKind, FaultSchedule)
    from repro_torch.core.coordinator import ASR, CheckpointPolicy
    from repro_torch.core.service import CACSService

    primary_backend = SnoozeBackend(n_hosts=n_hosts)
    standby_backend = OpenStackBackend(n_hosts=n_hosts)
    primary_store = InMemoryStore()
    standby_store = InMemoryStore()
    primary = CACSService({primary_backend.name: primary_backend},
                          {"default": primary_store})
    standby = CACSService({standby_backend.name: standby_backend},
                          {"default": standby_store})
    replicator = ImageReplicator(primary)
    replicator.add_target(StandbyTarget(
        "standby", store=standby_store, service=standby,
        backend=standby_backend.name, n_vms=n_vms))
    controller = FailoverController(primary, replicator)
    try:
        asr = ASR(name=f"failover-{seed}", n_vms=n_vms,
                  backend=primary_backend.name,
                  app_factory=lambda: SimulatedApp(iter_time_s=iter_time_s,
                                                   state_mb=state_mb),
                  policy=CheckpointPolicy(period_s=period_s, keep_last=3))
        cid = primary.submit(asr)
        primary.wait_for_state(cid, CoordState.RUNNING, timeout=60)
        primary.trigger_checkpoint(cid)    # a restore point always exists
        replicator.watch(cid, ReplicationPolicy(
            targets=("standby",), bandwidth_bps=bandwidth_bps))
        replicator.sync()                  # standby warm before the clock
        if continuous_replication:
            replicator.start()
        controller.start()

        schedule = FaultSchedule(seed=seed, events=[
            FaultEvent(at_s=outage_at_s, kind=FaultKind.CLOUD_OUTAGE)])
        chaos = ChaosController(primary, cid, primary_backend, schedule,
                                settle_timeout_s=settle_timeout_s,
                                failover=controller)
        primary_coord = primary.db.get(cid)
        chaos.run()
        if cid not in controller.results:
            raise RuntimeError("failover did not trigger "
                               f"(primary {primary_coord.state.value})")
        res = controller.results[cid]
        if not res.ok:
            raise RuntimeError(f"failover failed: {res.error}")

        # Freeze the standby before reading the restored image: the
        # resumed app checkpoints periodically under the adopted prefix,
        # and its keep_last GC would eventually prune res.step out from
        # under the restore below.
        standby.apps.stop_daemons()
        # RPO in iterations: what the restored image held vs where the
        # primary app actually was when the cloud died; read back onto the
        # device the standby application declares
        from repro_torch.ckpt.reader import restore
        from repro_torch.core.checkpoint_manager import app_device
        dst_coord = standby.db.get(res.dst_id)
        state, _ = restore(standby_store, primary_coord.ckpt_prefix,
                           res.step, device=app_device(dst_coord))
        return FailoverScenarioResult(
            seed=seed, outage_at_s=outage_at_s, failover=res,
            primary_final_state=primary_coord.state.value,
            standby_state=dst_coord.state.value,
            restored_iteration=int(state["iteration"]),
            primary_iteration=int(primary_coord.app.iteration),
            replication=res.replication or {},
            trace=[o.trace_key() for o in chaos.outcomes])
    finally:
        controller.stop()
        replicator.stop()
        standby.shutdown()
        primary.shutdown()
