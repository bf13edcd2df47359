"""Application Manager (paper §4.2): orchestrates the coordinator lifecycle.

Owns the bring-up pipeline (allocate -> provision -> start), the periodic
checkpoint daemon, and all recovery paths:
  * VM failure  -> passive recovery: replace unreachable VMs, restore from
                   the latest image, restart (paper §6.3 case 1);
  * app failure -> in-place restart on the same VMs (paper §6.3 case 2 —
                   "as an optimization");
  * straggler   -> proactive suspend to stable storage (paper §1: "detects
                   ... exceptionally low performance ... and proactively
                   suspends the job"); the scheduler resumes it later.

Port of ``repro/core/app_manager.py``.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from repro_torch.clusters.base import SimBackend
from repro_torch.clusters.simulator import CapacityError
from repro_torch.core.application import AppContext, snapshot_of
from repro_torch.core.checkpoint_manager import CheckpointManager
from repro_torch.core.cloud_manager import CloudManager
from repro_torch.obs.telemetry import registry
from repro_torch.obs.trace import tracer
from repro_torch.sim.simtime import active_clock
from repro_torch.core.coordinator import (ASR, Coordinator, CoordinatorDB,
                                          CoordState, InvalidTransition)
from repro_torch.core.gang import GANG_ROUTED, GANG_SHARDED, GangCoordinator
from repro_torch.core.monitoring import LowPerfConfig, MonitoringManager
from repro_torch.core.provision import ProvisionManager


def progress_counter(app: Any) -> Optional[Callable[[], float]]:
    """Monotonic progress counter for the monitor's throughput gauge:
    Trainer steps, Serve tokens, gang min-iteration, SimulatedApp
    iterations — falling back to ``progress()`` when nothing better
    exists. None when the app exposes no usable counter."""
    for attr in ("current_step", "generated", "iteration"):
        if hasattr(app, attr):
            def fn(a=app, name=attr) -> float:
                v = getattr(a, name)
                return float(v() if callable(v) else v)
            return fn
    if hasattr(app, "min_iteration"):
        return lambda: float(app.min_iteration())
    if hasattr(app, "progress"):
        return lambda: float(app.progress())
    return None


class AppManager:
    def __init__(self, db: CoordinatorDB, cloud: CloudManager,
                 provision: ProvisionManager, ckpt: CheckpointManager,
                 workers: int = 100, recover_retries: int = 2,
                 retry_backoff_s: float = 0.02,
                 lowperf: Optional[LowPerfConfig] = None):
        self.db = db
        self.cloud = cloud
        self.provision = provision
        self.ckpt = ckpt
        # "users requests are mostly treated in background using a pool of
        # threads" (§6.5) — sized for the paper's 100-concurrent-apps test.
        self.pool = cf.ThreadPoolExecutor(max_workers=workers,
                                          thread_name_prefix="appmgr")
        self.monitor = MonitoringManager(self._on_monitor_event,
                                         lowperf=lowperf)
        self._ckpt_daemon_stop = threading.Event()
        self._ckpt_daemon: Optional[threading.Thread] = None
        self._next_ckpt: Dict[str, float] = {}
        self._step_counter: Dict[str, int] = {}
        # At most one recovery/suspend action in flight per coordinator:
        # the monitor re-reports a fault every poll tick (~50 ms) for as
        # long as it persists, and duplicate submissions used to race into
        # RuntimeError tracebacks inside _guarded.
        self._inflight_ops: Dict[str, cf.Future] = {}
        self._inflight_lock = threading.Lock()
        self.events_deduped = 0
        # transient-fault tolerance on the restore path (chaos: a storage
        # get error mid-recovery should cost a retry, not an ERROR state)
        self.recover_retries = recover_retries
        self.retry_backoff_s = retry_backoff_s
        # per-coordinator gang barrier drivers (core/gang.py), kept across
        # restarts so epoch/abort counters and armed chaos hooks survive
        # a recovery — rebound to the restarted app at each use
        self._gangs: Dict[str, GangCoordinator] = {}

    # ------------------------------------------------------------------
    # Submission (paper §5.1)
    # ------------------------------------------------------------------
    def submit(self, asr: ASR, block: bool = False) -> Coordinator:
        coord = self.db.create(asr)
        fut = self.pool.submit(self._bringup, coord)
        if block:
            fut.result()
        return coord

    def enqueue(self, asr: ASR) -> Coordinator:
        """Admit a job without starting it: the record is created and
        parked in QUEUED (persisted — queued work survives a service
        restart), holding no resources until a scheduler calls
        ``start_queued`` (fresh bring-up) or ``restart_from`` (requeued
        jobs that already hold images)."""
        coord = self.db.create(asr)
        self.db.transition(coord, CoordState.QUEUED, "queued")
        return coord

    def start_queued(self, coord_id: str, block: bool = True) -> Coordinator:
        """Begin the bring-up of a QUEUED coordinator (allocate →
        provision → start). Capacity races surface as an ERROR record
        whose error names CapacityError; the scheduler requeues those."""
        coord = self.db.get(coord_id)
        with coord.lock:
            if coord.state != CoordState.QUEUED:
                raise RuntimeError(
                    f"cannot start queued job in state {coord.state.value}")
        fut = self.pool.submit(self._bringup, coord)
        if block:
            fut.result()
        return coord

    def _provision_cost(self, backend_name: str):
        backend = self.cloud.backend(backend_name)
        return {"cost": backend.sim.cost} if isinstance(backend, SimBackend) \
            else {}

    def _bringup_infra(self, coord: Coordinator) -> None:
        """CREATING -> PROVISIONING -> READY (allocate + provision)."""
        asr = coord.asr
        vms = self.cloud.create_cluster(asr.backend, asr.n_vms,
                                        asr.template, coord.coord_id)
        coord.vms = vms
        self.db.transition(coord, CoordState.PROVISIONING)
        self.provision.provision(vms, asr.provision_cmds,
                                 **self._provision_cost(asr.backend))
        self.db.transition(coord, CoordState.READY)

    def _bringup(self, coord: Coordinator,
                 restore_state: Any = None) -> None:
        try:
            self._bringup_infra(coord)
            self._start_app(coord, restore_state)
        except Exception as e:                     # noqa: BLE001
            coord.error = f"{e}\n{traceback.format_exc()}"
            try:
                self.db.transition(coord, CoordState.ERROR, str(e))
            except Exception:
                pass

    def _start_app(self, coord: Coordinator, restore_state: Any) -> bool:
        asr = coord.asr
        if coord.app is None:
            coord.app = asr.app_factory()
        backend = self.cloud.backend(asr.backend)
        ctx = AppContext(coord.coord_id, coord.vms, service=None,
                         trace_id=coord.trace_id)
        # gang apps exchange messages over the backend's simulated fabric;
        # handing it through the context keeps Application signature-stable
        ctx.transport = getattr(backend, "sim", None)
        coord.app.start(ctx, restore_state)
        try:
            self.db.transition(coord, CoordState.RUNNING)
        except InvalidTransition:
            # terminate() raced the bring-up/recovery: stop quietly and let
            # the terminating thread (which joins us) release the resources
            coord.app.stop()
            return False
        native = backend.supports_failure_notifications
        hook = asr.health_hook or (lambda: coord.app.healthy())
        self.monitor.watch(coord.coord_id, coord.vms, hook, native,
                           perf_fn=progress_counter(coord.app),
                           trace_id=coord.trace_id)
        if asr.policy.period_s > 0:
            clk = active_clock()
            self._next_ckpt[coord.coord_id] = (
                clk.now() + clk.from_wall(asr.policy.period_s))
        return True

    # ------------------------------------------------------------------
    # Gang jobs (core/gang.py): barrier driver plumbing
    # ------------------------------------------------------------------
    def gang(self, coord_id: str) -> Optional[GangCoordinator]:
        """The job's barrier driver (tests arm chaos hooks through it)."""
        return self._gangs.get(coord_id)

    def _gang(self, coord: Coordinator) -> GangCoordinator:
        transport = getattr(self.cloud.backend(coord.asr.backend), "sim",
                            None)

        def save_fn(step, trees):
            return self.ckpt.save_gang(coord, step, trees,
                                       sharded=GANG_SHARDED,
                                       routed=GANG_ROUTED)

        g = self._gangs.get(coord.coord_id)
        if g is None:
            g = GangCoordinator(coord.app, transport, save_fn,
                                trace_id=coord.trace_id)
            self._gangs[coord.coord_id] = g
        else:
            # the app instance / backend may have changed across a
            # recovery or cross-cloud retarget — repoint, keep counters
            g.rebind(coord.app, transport)
            g.save_fn = save_fn
        return g

    def _gang_snapshot(self, coord: Coordinator, step: int) -> None:
        """One barrier epoch; mirrors the driver's counters into the
        coordinator record so traces/metrics survive the driver."""
        g = self._gang(coord)
        try:
            g.snapshot(step)
        finally:
            coord.metrics.update(
                gang_epochs=g.epochs_committed, gang_aborts=g.aborts,
                gang_last_abort=g.last_abort_reason or "")

    # ------------------------------------------------------------------
    # Checkpointing (paper §5.2: user-initiated / periodic / app-initiated)
    # ------------------------------------------------------------------
    def checkpoint_now(self, coord_id: str, *, blocking: bool = True) -> int:
        coord = self.db.get(coord_id)
        with coord.lock:
            if coord.state not in (CoordState.RUNNING, CoordState.READY):
                raise RuntimeError(
                    f"cannot checkpoint in state {coord.state.value}")
            # a gang snapshot is cut by the barrier (quiesce + drain), not
            # by reading app state under the lock — only the step number
            # is claimed here. Staged apps hand back a handle in
            # microseconds; materialization runs on the writer thread.
            if coord.asr.gang:
                state = None
            else:
                with tracer().span("ckpt/pin", cat="ckpt",
                                   trace_id=coord.trace_id):
                    state = snapshot_of(coord.app)
            # claim the step under the lock: a concurrent suspend (or a
            # second checkpoint_now) must not mint the same step number
            step = self._step_counter.get(coord_id, 0) + 1
            self._step_counter[coord_id] = step
        if coord.asr.gang:
            # blocking by nature: the ranks stay quiesced until committed
            self._gang_snapshot(coord, step)
        else:
            self.ckpt.save(coord, step, state, blocking=blocking)
        return step

    def start_checkpoint_daemon(self, tick_s: float = 0.02) -> None:
        if self._ckpt_daemon is None:
            self._ckpt_daemon_stop.clear()
            self._ckpt_daemon = threading.Thread(
                target=self._ckpt_loop, args=(tick_s,), daemon=True)
            self._ckpt_daemon.start()
        self.monitor.start()

    def stop_daemons(self) -> None:
        self._ckpt_daemon_stop.set()
        if self._ckpt_daemon is not None:
            self._ckpt_daemon.join(timeout=5)
            self._ckpt_daemon = None
        self.monitor.stop()

    def _ckpt_loop(self, tick_s: float) -> None:
        while not active_clock().wait(self._ckpt_daemon_stop, tick_s):
            clk = active_clock()
            now = clk.now()
            for coord_id, due in list(self._next_ckpt.items()):
                if now < due:
                    continue
                try:
                    coord = self.db.get(coord_id)
                except KeyError:
                    self._next_ckpt.pop(coord_id, None)
                    continue
                if coord.state != CoordState.RUNNING:
                    continue
                try:
                    self.checkpoint_now(coord_id, blocking=False)
                except Exception as e:             # noqa: BLE001
                    # state raced (RuntimeError) or the store faulted
                    # (IOError): one app's bad save must not kill the
                    # periodic daemon for every app — skip this period,
                    # but leave a telemetry breadcrumb instead of vanishing
                    registry().inc("appmgr.daemon_errors",
                                   note=f"{type(e).__name__}: {e}")
                self._next_ckpt[coord_id] = (
                    now + clk.from_wall(coord.asr.policy.period_s))

    # ------------------------------------------------------------------
    # Recovery (paper §5.3 / §6.3)
    # ------------------------------------------------------------------
    def _on_monitor_event(self, coord_id: str, kind: str) -> None:
        try:
            coord = self.db.get(coord_id)
        except KeyError:
            return
        if kind in ("straggler", "low_performance"):
            action = getattr(coord.asr, "straggler_action", "suspend")
            done = False
            if coord.app is not None:
                try:
                    done = bool(coord.app.is_done())
                except Exception:                  # noqa: BLE001
                    done = False
            if action == "suspend" and not done:
                # the suspend reason keeps the detection path attributable
                # (chaos reads it to distinguish telemetry from liveness)
                self._submit_once(coord_id, self._suspend_if_running,
                                  coord_id, kind)
            return
        self._submit_once(coord_id, self._recover, coord_id, kind)

    def _submit_once(self, coord_id: str, fn, *args) -> Optional[cf.Future]:
        """Submit a recovery action unless one is already in flight for
        this coordinator. The monitor re-fires every poll tick while a
        fault persists (a straggler keeps straggling for the whole of the
        suspend's swap-out write) — duplicates are dropped, not raced."""
        with self._inflight_lock:
            if coord_id in self._inflight_ops:
                self.events_deduped += 1
                return None
            fut = self.pool.submit(self._guarded, fn, *args)
            self._inflight_ops[coord_id] = fut
        fut.add_done_callback(lambda _f: self._clear_inflight(coord_id))
        return fut

    def _clear_inflight(self, coord_id: str) -> None:
        with self._inflight_lock:
            self._inflight_ops.pop(coord_id, None)

    def _join_inflight(self, coord_id: str, timeout: float = 30.0) -> None:
        with self._inflight_lock:
            fut = self._inflight_ops.get(coord_id)
        if fut is not None:
            cf.wait([fut], timeout=timeout)

    def _guarded(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception as e:                     # noqa: BLE001
            registry().inc("appmgr.op_errors",
                           note=f"{type(e).__name__}: {e}")
            traceback.print_exc()

    def _suspend_if_running(self, coord_id: str, reason: str) -> None:
        """Monitor-driven suspend: losing the race to another state change
        (a concurrent recovery, terminate, or an earlier suspend that just
        won) is expected — swallow it instead of stack-tracing."""
        try:
            self.suspend(coord_id, reason)
        except (RuntimeError, KeyError):
            pass

    def _seed_step_counter(self, coord: Coordinator) -> None:
        """Re-seed the save counter from the newest COMMITTED image.

        Every restore path must do this: a fresh manager (service restart,
        clone target) or a restore to an earlier image would otherwise
        count from 0 again — the next save would clobber newer images and
        corrupt keep_last pruning / latest() ordering."""
        latest = self.ckpt.latest(coord)
        if latest is not None:
            cur = self._step_counter.get(coord.coord_id, 0)
            self._step_counter[coord.coord_id] = max(cur, latest)

    def _aborted(self, coord: Coordinator) -> bool:
        """True when this recovery no longer owns the coordinator (a
        concurrent terminate moved it out of RESTARTING)."""
        with coord.lock:
            return coord.state != CoordState.RESTARTING

    def _recover(self, coord_id: str, kind: str) -> None:
        coord = self.db.get(coord_id)
        with coord.lock:
            if coord.state != CoordState.RUNNING:
                return                              # debounce duplicates
            self.db.transition(coord, CoordState.RESTARTING, kind)
        self.monitor.unwatch(coord_id)
        coord.recoveries += 1
        t0 = active_clock().now()
        try:
            coord.app.stop()
            err = self.ckpt.wait(coord, strict=False)
            if err is not None:
                # an in-flight save died (e.g. transient storage fault);
                # the newest COMMITTED image is still the restore point
                coord.metrics["last_save_error"] = repr(err)
            if self._aborted(coord):
                return
            if kind == "vm_failure":
                # passive recovery: replace unreachable VMs with fresh ones
                self.provision.forget(coord.vms)
                fresh = self.cloud.replace_failed(
                    coord.asr.backend, coord.vms, coord.asr.template,
                    coord.coord_id)
                with coord.lock:
                    coord.vms = fresh
                if self._aborted(coord):
                    return                  # terminate() now owns the VMs
                self.provision.provision(fresh, coord.asr.provision_cmds,
                                         **self._provision_cost(coord.asr.backend))
            state = self._load_latest_with_retry(coord)
            self._seed_step_counter(coord)
            if self._aborted(coord):
                return
            if self._start_app(coord, state):
                coord.metrics["last_recovery_s"] = (
                    active_clock().now() - t0)
        except Exception as e:                     # noqa: BLE001
            coord.error = str(e)
            # Only flag ERROR while we still own the coordinator: if a
            # terminate() took it (TERMINATING), moving to ERROR — legal
            # from TERMINATING — would wedge terminate's final TERMINATED
            # transition.
            with coord.lock:
                if coord.state == CoordState.RESTARTING:
                    self.db.transition(coord, CoordState.ERROR, str(e))

    def _load_latest_with_retry(self, coord: Coordinator) -> Any:
        """Restore the newest COMMITTED image, absorbing transient storage
        errors (bounded retries). Returns None when no image exists yet."""
        for attempt in range(self.recover_retries + 1):
            try:
                latest = self.ckpt.latest(coord)
                if latest is None:
                    return None
                return self._load_state(coord, latest)
            except Exception:                      # noqa: BLE001
                if attempt >= self.recover_retries:
                    raise
                active_clock().sleep(self.retry_backoff_s * (attempt + 1))

    def _load_state(self, coord: Coordinator, step: Optional[int] = None):
        """Restore-path dispatch: gang images reshard onto however many
        VMs the coordinator holds NOW (shrink-restore after an outage
        lands on fewer ranks than the image was cut from)."""
        if coord.app is None:           # the image lands on its device
            coord.app = coord.asr.app_factory()
        if not coord.asr.gang:
            return self.ckpt.load(coord, step)
        n = len(coord.vms) or coord.asr.n_vms
        trees, _man, stats = self.ckpt.load_gang(coord, step, n_ranks=n)
        coord.metrics["gang_restore_ranks"] = n
        coord.metrics["gang_restore_fetches"] = stats["chunk_fetches"]
        coord.metrics["gang_restore_unique"] = stats["unique_chunks"]
        return trees

    def restart_from(self, coord_id: str, step: Optional[int] = None) -> None:
        """POST /coordinators/:id/checkpoints/:id — restart from an image.

        Covers all the paper's §5.3 cases: restart a running app from an
        earlier image; restart a suspended/errored app; and bring up a
        freshly-created clone target whose image was just uploaded ("this
        will trigger the passive recovery mechanism to generate a new
        virtual cluster").
        """
        coord = self.db.get(coord_id)
        fresh_clone = False
        with coord.lock:
            if coord.state == CoordState.RUNNING:
                self.db.transition(coord, CoordState.RESTARTING, "user")
                self.monitor.unwatch(coord_id)
                if coord.app is not None:      # rehydrated records
                    coord.app.stop()           # (CoordinatorDB.load) have
                                               # no live app to stop
            elif coord.state in (CoordState.SUSPENDED, CoordState.ERROR,
                                 CoordState.QUEUED):
                # QUEUED here is a *requeued* job (dead cloud / capacity
                # race) that already holds images — restart, don't rerun
                self.db.transition(coord, CoordState.RESTARTING, "user")
            elif coord.state == CoordState.CREATING:
                fresh_clone = True
            else:
                raise RuntimeError(f"cannot restart from {coord.state.value}")
        self.ckpt.wait(coord, strict=False)
        if fresh_clone:
            self._bringup_infra(coord)
        elif not coord.vms:
            coord.vms = self.cloud.create_cluster(
                coord.asr.backend, coord.asr.n_vms, coord.asr.template,
                coord.coord_id)
            self.provision.provision(coord.vms, coord.asr.provision_cmds,
                                     **self._provision_cost(coord.asr.backend))
        elif not all(vm.reachable for vm in coord.vms):
            self.provision.forget(coord.vms)
            coord.vms = self.cloud.replace_failed(
                coord.asr.backend, coord.vms, coord.asr.template,
                coord.coord_id)
            self.provision.provision(coord.vms, coord.asr.provision_cmds,
                                     **self._provision_cost(coord.asr.backend))
        state = self._load_state(coord, step)
        # seed from the NEWEST committed image (not the restored one): a
        # user restarting from an earlier image must not have the next
        # save clobber the newer images still in the store
        self._seed_step_counter(coord)
        self._start_app(coord, state)

    # ------------------------------------------------------------------
    # Job swapping (use case 2) + proactive suspend
    # ------------------------------------------------------------------
    def suspend(self, coord_id: str, reason: str = "user") -> None:
        coord = self.db.get(coord_id)
        with tracer().span("app/suspend", cat="app", trace_id=coord.trace_id,
                           args={"reason": reason}):
            self._suspend(coord, reason)

    def _suspend(self, coord: Coordinator, reason: str) -> None:
        coord_id = coord.coord_id
        # the job's progress read in the pin and again once it has stopped:
        # the work it did in between, which a resume of the image discards
        count = progress_counter(coord.app)
        pinned = None
        with coord.lock:
            if coord.state != CoordState.RUNNING:
                raise RuntimeError(f"cannot suspend {coord.state.value}")
            pol = coord.asr.policy
            swap_codec = pol.swap_codec or None
            if coord.asr.gang:
                state = None
            else:
                with tracer().span("ckpt/pin", cat="ckpt",
                                   trace_id=coord.trace_id,
                                   args={"suspend": reason}):
                    state = snapshot_of(coord.app, codec=swap_codec)
                    pinned = count() if count is not None else None
            step = self._step_counter.get(coord_id, 0) + 1
            self._step_counter[coord_id] = step
        # The blocking swap-out write runs OUTSIDE coord.lock: holding the
        # lock across a full save would stall checkpoint_now, the periodic
        # daemon and monitor-event handling for this coordinator for the
        # whole write. The snapshot above is already step-consistent (for
        # a gang job the barrier cuts it here instead — an epoch abort
        # fails the suspend with the job still RUNNING and unharmed).
        if coord.asr.gang:
            self._gang_snapshot(coord, step)
        else:
            self.ckpt.save(coord, step, state, blocking=True,
                           metadata={"suspend": reason}, codec=swap_codec)
        with coord.lock:
            if coord.state != CoordState.RUNNING:
                # a recovery/terminate won the race during the write; the
                # image is committed and harmless, but the suspend is off
                raise RuntimeError(
                    f"suspend({coord_id}) aborted: state became "
                    f"{coord.state.value} during swap-out")
            with tracer().span("app/stop", cat="app") as sp:
                coord.app.stop()
                if pinned is not None:
                    sp.set("work_lost", count() - pinned)
            # detach monitoring + the VM handles BEFORE publishing
            # SUSPENDED: the instant the new state is visible, a resume
            # may allocate a fresh cluster and re-watch — teardown must
            # only ever touch the old cluster
            self.monitor.unwatch(coord_id)
            self._next_ckpt.pop(coord_id, None)
            old_vms, coord.vms = coord.vms, []
            self.db.transition(coord, CoordState.SUSPENDED, reason)
        self.provision.forget(old_vms)
        with tracer().span("cloud/destroy", cat="cloud"):
            self.cloud.destroy_cluster(coord.asr.backend, old_vms)

    def resume(self, coord_id: str, block: bool = True) -> None:
        coord = self.db.get(coord_id)
        with coord.lock:
            if coord.state != CoordState.SUSPENDED:
                raise RuntimeError(f"cannot resume {coord.state.value}")
            self.db.transition(coord, CoordState.RESTARTING, "resume")

        def _bring_back():
            asr = coord.asr
            try:
                with tracer().span("cloud/create", cat="cloud"):
                    fresh = self.cloud.create_cluster(
                        asr.backend, asr.n_vms, asr.template, coord.coord_id)
            except CapacityError as e:
                # capacity raced away between the scheduler's check and
                # the claim: the job is still safely swapped out — return
                # to SUSPENDED so a later tick retries, don't wedge ERROR
                # (unless a terminate took ownership mid-resume)
                with coord.lock:
                    if coord.state == CoordState.RESTARTING:
                        self.db.transition(coord, CoordState.SUSPENDED,
                                           f"resume aborted: {e}")
                return
            except Exception as e:                 # noqa: BLE001
                # any other allocation failure must not strand the job in
                # RESTARTING (or kill a blocking caller's loop thread)
                coord.error = str(e)
                with coord.lock:
                    if coord.state == CoordState.RESTARTING:
                        self.db.transition(coord, CoordState.ERROR, str(e))
                return
            with coord.lock:
                owned = coord.state == CoordState.RESTARTING
                if owned:
                    coord.vms = fresh
            if not owned:
                # terminate() raced the resume: release what we claimed
                self.cloud.destroy_cluster(asr.backend, fresh)
                return
            try:
                with tracer().span("provision", cat="cloud"):
                    self.provision.provision(
                        coord.vms, asr.provision_cmds,
                        **self._provision_cost(asr.backend))
                state = self._load_state(coord)
                self._seed_step_counter(coord)
                with tracer().span("app/start", cat="app"):
                    self._start_app(coord, state)
            except Exception as e:                 # noqa: BLE001
                coord.error = str(e)
                with coord.lock:
                    if coord.state == CoordState.RESTARTING:
                        self.db.transition(coord, CoordState.ERROR, str(e))

        def _do():
            with tracer().span("app/resume", cat="app",
                               trace_id=coord.trace_id):
                _bring_back()

        if block:
            _do()
        else:
            self.pool.submit(_do)

    # ------------------------------------------------------------------
    # Termination (paper §5.4)
    # ------------------------------------------------------------------
    def terminate(self, coord_id: str, *, delete_images: bool = True) -> Dict:
        coord = self.db.get(coord_id)
        with coord.lock:
            self.db.transition(coord, CoordState.TERMINATING, "user")
        self.monitor.unwatch(coord_id)
        self._next_ckpt.pop(coord_id, None)
        # Join any in-flight recovery/suspend: it aborts at its next state
        # check (the TERMINATING transition above makes _aborted() true)
        # and must stop touching coord.vms before we destroy them.
        self._join_inflight(coord_id)
        if coord.app is not None:
            coord.app.stop()
        self.ckpt.wait(coord, strict=False)
        if coord.vms:
            self.provision.forget(coord.vms)
            self.cloud.destroy_cluster(coord.asr.backend, coord.vms)
            coord.vms = []
        if delete_images:
            self.ckpt.delete_all(coord)
        self._gangs.pop(coord_id, None)
        self.db.transition(coord, CoordState.TERMINATED)
        final = coord.to_dict()
        self.db.remove(coord_id)          # paper §5.4: delete the db entry
        return final
