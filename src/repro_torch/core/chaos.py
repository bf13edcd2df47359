"""Deterministic fault injection for the recovery control plane.

The paper's core promise is *survival*: the service "detects when
long-running jobs either fail or incur exceptionally low performance, and
proactively suspends the job" (§1, §6.3). This module turns that claim into
a replayable, measurable scenario suite:

  * :class:`FaultSchedule` — a seeded, typed list of fault events (VM crash,
    host slowdown/straggler, app health-hook failure, transient storage
    put/get errors, monitor partition). Same seed → same schedule, always.
  * :class:`ChaosController` — applies a schedule to a live
    :class:`~repro_torch.core.service.CACSService` running on the cluster
    simulator, on a virtual clock (wall time / ``TIME_SCALE``), waiting for
    each fault's recovery to settle so the resulting *event trace* —
    (fault, target, outcome, final state) per event, plus every simulator
    fault hook firing — replays identically from the seed.
  * per-fault :class:`FaultOutcome` — detection latency, restore time and
    end-to-end MTTR, measured from the coordinator's state history (the
    §6.3 case-1/case-2 split: VM failure → replace + restore; app failure →
    in-place restart; straggler → proactive suspend, then resume).

Fault classes and what each one proves:

  ``vm_crash``           IaaS host dies. Native backends (Snooze) notify
                         immediately; agent backends (OpenStack) detect via
                         the broadcast tree. Recovery: replace + restore.
  ``monitor_partition``  host alive but unreachable by the monitoring tree.
                         No native notification ever fires — only the
                         tree's consecutive-unreachable fallback catches it.
  ``app_failure``        the application health hook *raises* (a broken
                         user hook must read as an unhealthy app, not kill
                         the monitor thread). Recovery: in-place restart.
  ``host_slowdown``      straggler. Monitor z-scores it; the app manager
                         proactively suspends to stable storage; the
                         controller (or the GlobalScheduler) resumes it.
  ``storage_put_fault``  transient store error mid-save. The COMMITTED
                         protocol must leave the previous image loadable
                         and the torn step invisible.
  ``storage_get_fault``  transient store error mid-restore, injected under
                         an app failure. The recovery retry loop absorbs it.

Used by `tests/test_chaos.py` (replay determinism + recovery-race
regression suite), `benchmarks/fault_recovery.py` (MTTR per fault class ×
monitoring path) and `examples/fault_tolerance.py` (seeded storyline).

Port of ``repro/core/chaos.py``.
"""
from __future__ import annotations

import dataclasses
import enum
import random
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.ckpt.storage import (ChaosStorageError, FaultyStore,
                                      InMemoryStore)
from repro_torch.clusters.simulator import TIME_SCALE
from repro_torch.sim.simtime import active_clock
from repro_torch.core.coordinator import ASR, CheckpointPolicy, CoordState


class FaultKind(str, enum.Enum):
    VM_CRASH = "vm_crash"
    HOST_SLOWDOWN = "host_slowdown"
    APP_FAILURE = "app_failure"
    STORAGE_PUT_FAULT = "storage_put_fault"
    STORAGE_GET_FAULT = "storage_get_fault"
    MONITOR_PARTITION = "monitor_partition"
    # whole-cloud outage: every host of the backend partitioned at once
    # AND allocation denied — unrecoverable on the home cloud by design;
    # the expected outcome is cross-cloud failover (core/replication.py),
    # not a same-cloud recovery cycle. Appended last so pre-existing
    # seeded schedules (rng.choice over the earlier kinds) replay
    # unchanged.
    CLOUD_OUTAGE = "cloud_outage"
    # gang-barrier faults: armed as one-shot hooks on the job's
    # GangCoordinator and fired at a protocol phase boundary — the fault
    # lands at an exact protocol position, not a timing race, which is
    # what makes mid-barrier chaos replayable. Each must abort the epoch
    # all-or-nothing: no torn gang image, previous image restorable,
    # every rank released. Appended after CLOUD_OUTAGE for the same
    # seed-replay reason.
    GANG_BARRIER_CRASH = "gang_barrier_crash"
    GANG_BARRIER_PARTITION = "gang_barrier_partition"
    GANG_BARRIER_STRAGGLER = "gang_barrier_straggler"
    GANG_BARRIER_PUT_FAULT = "gang_barrier_put_fault"


# kinds whose outcome is a full recovery cycle back to RUNNING
_RECOVERY_KINDS = (FaultKind.VM_CRASH, FaultKind.APP_FAILURE,
                   FaultKind.MONITOR_PARTITION, FaultKind.STORAGE_GET_FAULT)

# gang-barrier kinds: only meaningful for a gang job (asr.gang=True);
# settled by _settle_gang, never part of the default generate pool
GANG_KINDS = (FaultKind.GANG_BARRIER_CRASH, FaultKind.GANG_BARRIER_PARTITION,
              FaultKind.GANG_BARRIER_STRAGGLER,
              FaultKind.GANG_BARRIER_PUT_FAULT)

# kinds a single-cloud scenario can survive — the default pool for
# FaultSchedule.generate (CLOUD_OUTAGE needs a standby cloud to end well,
# and gang kinds need a gang job, so both must be opted into explicitly;
# keeping them out also keeps rng.choice draws identical for old seeds)
SINGLE_CLOUD_KINDS = tuple(k for k in FaultKind
                           if k is not FaultKind.CLOUD_OUTAGE
                           and k not in GANG_KINDS)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One typed fault, scheduled at a virtual-time offset."""
    at_s: float                  # virtual seconds after scenario start
    kind: FaultKind
    vm_index: int = 0            # which of the coordinator's VMs to hit
    slowdown: float = 20.0       # HOST_SLOWDOWN: step-time multiplier
    n_ops: int = 1               # STORAGE_*: how many ops fail
    n_vms: int = 1               # MONITOR_PARTITION: subtree size
    phase: str = "drain"         # GANG_BARRIER_*: protocol phase to hit

    def label(self) -> str:
        return f"{self.kind.value}@{self.at_s:.1f}s/vm{self.vm_index}"


@dataclasses.dataclass
class FaultSchedule:
    """A seeded, replayable fault storyline.

    ``generate`` derives everything from ``random.Random(seed)`` — no wall
    clock, no global state — so the same seed always yields the same
    events, which is the first half of the determinism contract (the
    second half is the controller waiting for each recovery to settle).
    """
    seed: int
    events: List[FaultEvent]

    @classmethod
    def generate(cls, seed: int, n_events: int = 5, *,
                 horizon_s: float = 40.0, n_vms: int = 4,
                 kinds: Tuple[FaultKind, ...] = SINGLE_CLOUD_KINDS,
                 min_gap_s: float = 2.0) -> "FaultSchedule":
        rng = random.Random(seed)
        times = sorted(rng.uniform(1.0, horizon_s) for _ in range(n_events))
        # enforce a minimum gap so two faults never target the same
        # recovery window (the controller settles between events anyway)
        for i in range(1, len(times)):
            times[i] = max(times[i], times[i - 1] + min_gap_s)
        events = []
        for t in times:
            kind = rng.choice(list(kinds))
            events.append(FaultEvent(
                at_s=round(t, 3), kind=kind,
                vm_index=rng.randrange(n_vms),
                slowdown=float(rng.choice((10.0, 20.0, 50.0))),
                # get faults must stay within the recovery retry budget
                n_ops=rng.randint(1, 2),
                n_vms=rng.randint(1, max(1, n_vms // 2))))
        return cls(seed=seed, events=events)

    @classmethod
    def storyline(cls, seed: int = 42, n_vms: int = 4) -> "FaultSchedule":
        """A curated multi-fault storyline touching every fault class, with
        seed-derived jitter on targets and timing."""
        rng = random.Random(seed)
        j = lambda: round(rng.uniform(0.0, 1.5), 3)      # noqa: E731
        v = lambda: rng.randrange(n_vms)                  # noqa: E731
        return cls(seed=seed, events=[
            FaultEvent(2.0 + j(), FaultKind.VM_CRASH, vm_index=v()),
            FaultEvent(8.0 + j(), FaultKind.STORAGE_PUT_FAULT, n_ops=2),
            FaultEvent(12.0 + j(), FaultKind.APP_FAILURE),
            FaultEvent(18.0 + j(), FaultKind.MONITOR_PARTITION,
                       vm_index=v(), n_vms=2),
            FaultEvent(24.0 + j(), FaultKind.STORAGE_GET_FAULT, n_ops=1),
            FaultEvent(30.0 + j(), FaultKind.HOST_SLOWDOWN, vm_index=v(),
                       slowdown=50.0),
        ])

    def describe(self) -> List[str]:
        return [e.label() for e in self.events]


@dataclasses.dataclass
class FaultOutcome:
    """What one injected fault did to the control plane (wall seconds)."""
    event: FaultEvent
    ok: bool
    final_state: str
    detection_s: Optional[float] = None   # inject → leave RUNNING
    restore_s: Optional[float] = None     # leave RUNNING → back up
    mttr_s: Optional[float] = None        # inject → back up (end to end)
    recoveries: int = 0
    detail: str = ""
    trace_id: str = ""                    # job trace id (deterministic)
    # which watchdog caught it: "telemetry" (low-performance EWMA),
    # "monitor" (liveness/straggler path), or "" (not detection-driven)
    detected_by: str = ""

    def trace_key(self) -> Tuple:
        """Wall-time-free identity of this outcome, for replay equality.

        Only the first detail token is part of the identity: for storage
        faults the trailing tokens record *which* save absorbed the fault
        (explicit trigger vs periodic daemon), which is scheduling, not
        outcome."""
        return (self.event.kind.value, self.event.vm_index, self.ok,
                self.final_state, self.detail.split(";")[0])


@dataclasses.dataclass
class ScenarioResult:
    seed: int
    trace: List[Tuple]                    # outcome trace keys, in order
    sim_faults: List[Tuple[str, str, float]]   # (kind, host_id, value)
    outcomes: List[FaultOutcome]
    final_state: str
    recoveries: int
    events_deduped: int
    partition_fallbacks: int

    @property
    def all_ok(self) -> bool:
        return all(o.ok for o in self.outcomes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed, "trace": [list(t) for t in self.trace],
            "final_state": self.final_state, "recoveries": self.recoveries,
            "events_deduped": self.events_deduped,
            "partition_fallbacks": self.partition_fallbacks,
            "all_ok": self.all_ok,
            "outcomes": [{
                "fault": o.event.kind.value, "ok": o.ok,
                "final_state": o.final_state, "detail": o.detail,
                "trace_id": o.trace_id, "detected_by": o.detected_by,
                "detection_s": o.detection_s, "restore_s": o.restore_s,
                "mttr_s": o.mttr_s} for o in self.outcomes],
        }


class VirtualClock:
    """Paper-seconds view anchored at construction over the *installed*
    clock (repro_torch.sim).  Under the default WallClock this is
    ``TIME_SCALE`` wall seconds per virtual second, matching
    ``sim_sleep``'s compression (unchanged historical behavior); under a SimClock the virtual axis is
    already paper seconds, so sleeps jump instantly.  Event offsets in a
    schedule are paper-calibrated (virtual) seconds either way."""

    def __init__(self, time_scale: Optional[float] = None):
        self._clk = active_clock()
        # native seconds of the underlying clock per virtual second
        self.scale = self._clk.scale if time_scale is None else time_scale
        self._t0 = self._clk.now()

    def now(self) -> float:
        return (self._clk.now() - self._t0) / self.scale

    def sleep_until(self, t_virtual: float) -> None:
        delta = t_virtual - self.now()
        if delta > 0:
            self._clk.sleep_until(self._clk.now() + delta * self.scale)


class ChaosHealthHook:
    """Armable application health hook.

    Normally reports healthy; ``arm(n)`` makes the next *n* calls RAISE —
    the harshest form of "app health-hook failure" (a hook returning False
    is polite; real user hooks crash). The monitor must translate the
    raise into an app_failure report, not die."""

    def __init__(self):
        self._armed = 0

    def arm(self, n: int = 1) -> None:
        self._armed = max(0, int(n))

    def __call__(self) -> bool:
        if self._armed > 0:
            self._armed -= 1
            raise RuntimeError("injected health-hook failure")
        return True


class ChaosController:
    """Applies a FaultSchedule to one coordinator on a live service.

    Events run in virtual-time order; after each fault the controller
    waits for the recovery to settle (back to RUNNING, or SUSPENDED→
    resumed for stragglers) before the next event, which is what makes
    the outcome trace replayable. Detection/restore/MTTR are read from
    the coordinator's transition history (wall-clock timestamps)."""

    def __init__(self, service, coord_id: str, backend, schedule: FaultSchedule,
                 *, store: Optional[FaultyStore] = None,
                 hook: Optional[ChaosHealthHook] = None,
                 settle_timeout_s: float = 60.0,
                 resume_stragglers: bool = True,
                 failover=None, scheduler=None):
        self.service = service
        self.coord_id = coord_id
        self.backend = backend
        self.schedule = schedule
        self.store = store
        self.hook = hook
        self.settle_timeout_s = settle_timeout_s
        self.resume_stragglers = resume_stragglers
        # optional replication.FailoverController: cloud_outage events then
        # settle on the standby coming up instead of on primary recovery
        self.failover = failover
        # optional GlobalScheduler: kicked after every injection, and
        # cloud_outage then settles on the scheduler requeuing the job and
        # backfilling it onto a surviving cloud (same coordinator record,
        # unlike the FailoverController's standby-service restart)
        self.scheduler = scheduler
        self.outcomes: List[FaultOutcome] = []
        self.sim_faults: List[Tuple[str, str, float]] = []
        self._gang_heal = None         # undo for the current gang fault
        backend.sim.on_fault(
            lambda kind, host, value: self.sim_faults.append(
                (kind, host, value)))

    # ---- driving -------------------------------------------------------
    def run(self) -> List[FaultOutcome]:
        clock = VirtualClock()
        for ev in sorted(self.schedule.events, key=lambda e: e.at_s):
            clock.sleep_until(ev.at_s)
            self._apply(ev)
        return self.outcomes

    def _coord(self):
        return self.service.db.get(self.coord_id)

    def _wait(self, pred, timeout: Optional[float] = None) -> bool:
        # settle polling rides the installed clock: the deadline elapses in
        # virtual time under a SimClock (the old wall-clock loop was a
        # leak that kept chaos runs pinned to real seconds)
        clk = active_clock()
        deadline = clk.now() + clk.from_wall(timeout or self.settle_timeout_s)
        while clk.now() < deadline:
            if pred():
                return True
            clk.sleep(0.002)
        return False

    def _apply(self, ev: FaultEvent) -> None:
        coord = self._coord()
        if not self._wait(lambda: coord.state == CoordState.RUNNING):
            self.outcomes.append(FaultOutcome(
                ev, ok=False, final_state=coord.state.value,
                detail="not RUNNING at inject time",
                trace_id=coord.trace_id))
            return
        h0 = len(coord.history)
        rec0 = coord.recoveries
        t_inj = active_clock().timestamp()
        try:
            apply = getattr(self, f"_inject_{ev.kind.value}")
            detail = apply(ev, coord) or ""
        except Exception as e:                     # noqa: BLE001
            self.outcomes.append(FaultOutcome(
                ev, ok=False, final_state=coord.state.value,
                detail=f"inject failed: {type(e).__name__}",
                trace_id=coord.trace_id))
            return
        if self.scheduler is not None:
            self.scheduler.kick("chaos")
        self._settle(ev, coord, h0, rec0, t_inj, detail)

    # ---- injectors (one per fault class) --------------------------------
    def _inject_vm_crash(self, ev: FaultEvent, coord) -> str:
        vm = coord.vms[ev.vm_index % len(coord.vms)]
        self.backend.sim.fail_host(vm.host.host_id)
        return "crash"

    def _inject_monitor_partition(self, ev: FaultEvent, coord) -> str:
        n = max(1, min(ev.n_vms, len(coord.vms)))
        start = ev.vm_index % len(coord.vms)
        for i in range(n):
            vm = coord.vms[(start + i) % len(coord.vms)]
            self.backend.sim.partition_host(vm.host.host_id)
        return f"partition:{n}"

    def _inject_app_failure(self, ev: FaultEvent, coord) -> str:
        if self.hook is not None:
            self.hook.arm(1)
            return "hook-raise"
        app = coord.app
        if hasattr(app, "poison"):
            app.poison()
            return "poison"
        raise ValueError("no ChaosHealthHook and app has no poison()")

    def _inject_cloud_outage(self, ev: FaultEvent, coord) -> str:
        self.backend.sim.cloud_outage()
        return "outage"

    def _inject_host_slowdown(self, ev: FaultEvent, coord) -> str:
        vm = coord.vms[ev.vm_index % len(coord.vms)]
        self.backend.sim.degrade_host(vm.host.host_id, ev.slowdown)
        return f"slowdown:{ev.slowdown:g}"

    def _inject_storage_put_fault(self, ev: FaultEvent, coord) -> str:
        if self.store is None:
            raise ValueError("storage faults need a FaultyStore")
        self.store.arm_put_errors(ev.n_ops)
        return f"put-faults:{ev.n_ops}"

    def _gang_ctl(self):
        g = self.service.apps.gang(self.coord_id)
        if g is None:
            raise ValueError("gang faults need a gang job (asr.gang=True) "
                             "with at least one snapshot taken")
        return g

    def _inject_gang_barrier_crash(self, ev: FaultEvent, coord) -> str:
        g = self._gang_ctl()
        hid = coord.vms[ev.vm_index % len(coord.vms)].host.host_id
        g.arm(ev.phase, lambda: self.backend.sim.fail_host(hid))
        return f"crash@{ev.phase}"

    def _inject_gang_barrier_partition(self, ev: FaultEvent, coord) -> str:
        g = self._gang_ctl()
        hid = coord.vms[ev.vm_index % len(coord.vms)].host.host_id
        g.arm(ev.phase, lambda: self.backend.sim.partition_host(hid))
        return f"partition@{ev.phase}"

    def _inject_gang_barrier_straggler(self, ev: FaultEvent, coord) -> str:
        # a degrade armed at quiesce entry would land too late — the rank
        # checks the pause flag before each sleep and would still ack in
        # time. Degrade now and let the rank ENTER its slowed iteration
        # before the settle phase raises the barrier; only a slowdown
        # that outsleeps the whole ack budget (timeout × retries +
        # backoffs) then reads as a straggler.
        self._gang_ctl()                   # validate: gang job, primed
        hid = coord.vms[ev.vm_index % len(coord.vms)].host.host_id
        self.backend.sim.degrade_host(hid, ev.slowdown)
        active_clock().paper_sleep(1.0)
        self._gang_heal = lambda: self.backend.sim.degrade_host(hid, 1.0)
        return f"straggler:{ev.slowdown:g}"

    def _inject_gang_barrier_put_fault(self, ev: FaultEvent, coord) -> str:
        if self.store is None:
            raise ValueError("storage faults need a FaultyStore")
        g = self._gang_ctl()
        rank = ev.vm_index % len(coord.vms)
        scope = f"{coord.ckpt_prefix}/cas/r{rank}-"
        g.arm("save", lambda: self.store.arm_put_errors(ev.n_ops,
                                                        key_prefix=scope))
        return f"put-faults:r{rank}x{ev.n_ops}"

    def _inject_storage_get_fault(self, ev: FaultEvent, coord) -> str:
        if self.store is None:
            raise ValueError("storage faults need a FaultyStore")
        # a get fault only bites on a restore path: pair it with an app
        # failure so the recovery's restore absorbs it via retries
        self.store.arm_get_errors(ev.n_ops)
        if self.hook is not None:
            self.hook.arm(1)
        elif hasattr(coord.app, "poison"):
            coord.app.poison()
        return f"get-faults:{ev.n_ops}"

    # ---- settlement + measurement ---------------------------------------
    def _settle(self, ev: FaultEvent, coord, h0: int, rec0: int,
                t_inj: float, detail: str) -> None:
        if ev.kind == FaultKind.STORAGE_PUT_FAULT:
            self._settle_put_fault(ev, coord, detail)
            return
        if ev.kind == FaultKind.CLOUD_OUTAGE:
            self._settle_cloud_outage(ev, coord, h0, t_inj, detail)
            return
        if ev.kind in GANG_KINDS:
            self._settle_gang(ev, coord, h0, rec0, t_inj, detail)
            return
        detected_by = ""
        if ev.kind == FaultKind.HOST_SLOWDOWN:
            ok_end = self._wait(
                lambda: coord.state == CoordState.SUSPENDED)
            # which watchdog pulled the trigger: the suspend reason rides
            # on the SUSPENDED history entry ("low_performance" = the
            # telemetry EWMA detector, "straggler" = liveness heartbeat)
            reason = next((r[2] for r in coord.history[h0:]
                           if r[1] == "SUSPENDED" and len(r) > 2 and r[2]),
                          "")
            detected_by = ("telemetry" if reason == "low_performance"
                           else ("monitor" if reason else ""))
            if ok_end and self.resume_stragglers:
                self.service.apps.resume(self.coord_id, block=True)
                ok_end = coord.state == CoordState.RUNNING
        else:
            ok_end = self._wait(
                lambda: (coord.recoveries > rec0
                         and coord.state == CoordState.RUNNING))
        detection, restore, mttr = self._measure(ev, coord, h0, t_inj)
        self.outcomes.append(FaultOutcome(
            ev, ok=bool(ok_end), final_state=coord.state.value,
            detection_s=detection, restore_s=restore, mttr_s=mttr,
            recoveries=coord.recoveries, detail=detail,
            trace_id=coord.trace_id, detected_by=detected_by))

    def _settle_cloud_outage(self, ev: FaultEvent, coord, h0: int,
                             t_inj: float, detail: str) -> None:
        """A whole-cloud outage must fail conclusively on the home cloud
        (recovery exhausts into ERROR — no capacity exists), and, when a
        FailoverController is attached, end with the job RUNNING on a
        standby cloud. MTTR is then injection → standby RUNNING."""
        def primary_failed() -> bool:
            return any(s == "ERROR" for _, s, *_ in coord.history[h0:])
        ok = self._wait(primary_failed)
        t_error = next((t for t, s, *_ in coord.history[h0:]
                        if s == "ERROR"), None)
        detection = (None if t_error is None
                     else max(0.0, t_error - t_inj))
        restore = mttr = None
        if self.scheduler is not None and self.failover is None:
            # scheduler-managed job: the GlobalScheduler requeues it off
            # the dead cloud and backfills it onto a surviving one —
            # settle on the SAME coordinator coming back up
            got = self._wait(lambda: coord.state == CoordState.RUNNING)
            ok = ok and got
            if got:
                detail += f";backfill={coord.asr.backend}"
                t_up = next((t for t, s, *_ in reversed(coord.history)
                             if s == "RUNNING"), None)
                restore = (None if t_error is None or t_up is None
                           else max(0.0, t_up - t_error))
                mttr = None if t_up is None else max(0.0, t_up - t_inj)
        elif self.failover is not None:
            got = self._wait(lambda: self.coord_id in self.failover.results)
            res = self.failover.results.get(self.coord_id)
            ok = ok and got and res is not None and res.ok
            if res is not None and res.ok:
                detail += f";standby={res.target};step={res.step}"
                restore = res.restart_s
                mttr = None if detection is None or res.mttr_s is None \
                    else detection + res.mttr_s
            elif res is not None:
                detail += f";failover_error={res.error}"
        self.outcomes.append(FaultOutcome(
            ev, ok=bool(ok), final_state=coord.state.value,
            detection_s=detection, restore_s=restore, mttr_s=mttr,
            recoveries=coord.recoveries, detail=detail,
            trace_id=coord.trace_id))

    def _settle_gang(self, ev: FaultEvent, coord, h0: int, rec0: int,
                     t_inj: float, detail: str) -> None:
        """Armed gang faults fire inside the next snapshot's barrier:
        trigger it, prove the epoch aborted all-or-nothing (the torn step
        stays invisible, the previous committed gang image is still
        restorable at full rank count), then prove the plane heals — for
        crash/partition through the normal recovery cycle (replace +
        gang restore), otherwise by the very next snapshot committing."""
        g = self._gang_ctl()
        aborts0, commits0 = g.aborts, g.epochs_committed
        latest0 = self.service.ckpt.latest(coord)
        snapshot_failed = False
        try:
            self.service.trigger_checkpoint(self.coord_id)
        except Exception:                      # noqa: BLE001
            snapshot_failed = True
        if self.store is not None:
            self.store.disarm()
        heal, self._gang_heal = self._gang_heal, None
        ok = snapshot_failed and g.aborts == aborts0 + 1
        note = f"abort={g.last_abort_reason}"
        try:
            latest1 = self.service.ckpt.latest(coord)
            if latest1 != latest0:
                ok, note = False, note + ";torn image visible"
            elif latest0 is not None:
                n = len(coord.vms) or coord.asr.n_vms
                self.service.ckpt.load_gang(coord, latest0, n_ranks=n)
        except Exception as e:                 # noqa: BLE001
            ok, note = False, note + f";restore failed: {type(e).__name__}"
        if ev.kind in (FaultKind.GANG_BARRIER_CRASH,
                       FaultKind.GANG_BARRIER_PARTITION):
            # the fabric fault outlives the barrier: the monitor must now
            # drive a normal recovery cycle off the intact previous image
            got = self._wait(lambda: (coord.recoveries > rec0
                                      and coord.state == CoordState.RUNNING))
            ok = ok and got
            if not got:
                note += ";recovery failed"
        else:
            if heal is not None:
                heal()
            # healing a degraded host does not shorten a slow sleep the
            # rank already entered (its duration was computed at sleep
            # start), so the first resnapshot may still hit a stale
            # straggler — retry across that drain window
            err: Optional[Exception] = None
            for _ in range(4):
                try:
                    self.service.trigger_checkpoint(self.coord_id)
                    err = None
                    break
                except Exception as e:         # noqa: BLE001
                    err = e
                    active_clock().paper_sleep(5.0)
            if err is not None:
                ok, note = (False,
                            note + f";resnapshot failed: {type(err).__name__}")
            elif g.epochs_committed <= commits0:
                ok, note = False, note + ";resnapshot did not commit"
        detection, restore, mttr = self._measure(ev, coord, h0, t_inj)
        self.outcomes.append(FaultOutcome(
            ev, ok=bool(ok), final_state=coord.state.value,
            detection_s=detection, restore_s=restore, mttr_s=mttr,
            recoveries=coord.recoveries,
            detail=f"{detail};{note}", trace_id=coord.trace_id))

    def _settle_put_fault(self, ev: FaultEvent, coord, detail: str) -> None:
        """A save must fail without tearing anything: force a checkpoint
        into the armed faults, then prove the newest COMMITTED image still
        restores and a later save succeeds."""
        save_failed = False
        try:
            self.service.trigger_checkpoint(self.coord_id)
        except (ChaosStorageError, IOError):
            save_failed = True
        self.store.disarm()
        ok = True
        note = "previous image intact"
        try:
            latest = self.service.ckpt.latest(coord)
            if latest is not None:
                self.service.ckpt.load(coord, latest)
            # the plane must be healthy again: next save commits
            step = self.service.trigger_checkpoint(self.coord_id)
            if latest is not None and step <= latest:
                ok, note = False, "step counter regressed"
        except Exception as e:                     # noqa: BLE001
            ok, note = False, f"restore failed: {type(e).__name__}"
        self.outcomes.append(FaultOutcome(
            ev, ok=ok, final_state=coord.state.value,
            recoveries=coord.recoveries,
            detail=f"{detail};save_failed={save_failed};{note}",
            trace_id=coord.trace_id))

    def _measure(self, ev: FaultEvent, coord, h0: int, t_inj: float):
        """Detection / restore / MTTR from the coordinator history.

        Definitions (docs/architecture.md "Failure model & recovery"):
          * detection  = inject → first RESTARTING (for stragglers: the
            SUSPENDED transition — i.e. including the swap-out write);
          * restore    = that transition → the next RUNNING;
          * MTTR       = inject → back to RUNNING (or SUSPENDED when the
            controller does not resume stragglers)."""
        hist = coord.history[h0:]
        t_detect = t_up = None
        for t, state, *_ in hist:
            if t_detect is None and state in ("RESTARTING", "SUSPENDED"):
                t_detect = t
            elif t_detect is not None and state == "RUNNING":
                t_up = t
                break
        if ev.kind == FaultKind.HOST_SLOWDOWN and not self.resume_stragglers:
            t_up = t_detect
        detection = None if t_detect is None else max(0.0, t_detect - t_inj)
        restore = (None if t_detect is None or t_up is None
                   else max(0.0, t_up - t_detect))
        mttr = None if t_up is None else max(0.0, t_up - t_inj)
        return detection, restore, mttr


def run_scenario(schedule: FaultSchedule, *, backend_cls=None,
                 n_hosts: int = 16, n_vms: int = 4, period_s: float = 0.0,
                 iter_time_s: float = 0.4, state_mb: float = 0.05,
                 keep_last: int = 3, settle_timeout_s: float = 60.0,
                 store_latency_s: float = 0.0,
                 resume_stragglers: bool = True) -> ScenarioResult:
    """Bring up a single-app service on a fresh simulator, drive the
    schedule through it, tear everything down, return the result.

    The service runs with periodic checkpointing off by default
    (``period_s=0``) so storage-fault events interleave deterministically
    with the controller's explicit checkpoints; pass a period to run the
    daemon as well (the storyline example does)."""
    from repro_torch.clusters import (OpenStackBackend,  # noqa: F401
                                      SnoozeBackend)
    from repro_torch.core.application import SimulatedApp
    from repro_torch.core.service import CACSService

    backend_cls = backend_cls or SnoozeBackend
    backend = backend_cls(n_hosts=n_hosts)
    store = FaultyStore(InMemoryStore(latency_s=store_latency_s))
    svc = CACSService({backend.name: backend}, {"default": store})
    # host_slowdown is detected through TELEMETRY (the throughput-EWMA
    # watchdog), not liveness: the straggler heartbeat check is disabled
    # outright and the low-performance detector enabled with chaos-paced
    # polls (0.01 wall-tuned = 1 paper-second apart) and a short warmup
    # so a fault landing a few seconds in still sees a clean baseline
    from repro_torch.core.monitoring import LowPerfConfig
    svc.apps.monitor.straggler_threshold = float("inf")
    svc.apps.monitor.poll_interval_s = 0.01
    svc.apps.monitor.lowperf = LowPerfConfig(warmup_samples=2)
    hook = ChaosHealthHook()
    asr = ASR(name=f"chaos-{schedule.seed}", n_vms=n_vms,
              backend=backend.name,
              app_factory=lambda: SimulatedApp(iter_time_s=iter_time_s,
                                               state_mb=state_mb),
              policy=CheckpointPolicy(period_s=period_s,
                                      keep_last=keep_last),
              health_hook=hook)
    cid = svc.submit(asr)
    try:
        svc.wait_for_state(cid, CoordState.RUNNING, timeout=60)
        svc.trigger_checkpoint(cid)        # a restore point always exists
        ctrl = ChaosController(svc, cid, backend, schedule, store=store,
                               hook=hook, settle_timeout_s=settle_timeout_s,
                               resume_stragglers=resume_stragglers)
        outcomes = ctrl.run()
        coord = svc.db.get(cid)
        return ScenarioResult(
            seed=schedule.seed,
            trace=[o.trace_key() for o in outcomes],
            sim_faults=list(ctrl.sim_faults),
            outcomes=outcomes,
            final_state=coord.state.value,
            recoveries=coord.recoveries,
            events_deduped=svc.apps.events_deduped,
            partition_fallbacks=svc.apps.monitor.partition_fallbacks)
    finally:
        svc.shutdown()


def run_gang_scenario(schedule: FaultSchedule, *, n_hosts: int = 8,
                      n_vms: int = 4, min_vms: int = 2,
                      global_rows: int = 16, iter_time_s: float = 0.05,
                      keep_last: int = 3,
                      settle_timeout_s: float = 60.0) -> ScenarioResult:
    """Gang variant of :func:`run_scenario`: one multi-VM gang job
    (``asr.gang=True``) on a fresh simulator, with a first committed gang
    image taken before the schedule runs — GANG_BARRIER_* events arm
    their hooks on the job's GangCoordinator and fire inside the next
    snapshot's barrier."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core.gang import GangApp
    from repro_torch.core.service import CACSService

    backend = SnoozeBackend(n_hosts=n_hosts)
    store = FaultyStore(InMemoryStore())
    svc = CACSService({backend.name: backend}, {"default": store})
    asr = ASR(name=f"gang-{schedule.seed}", n_vms=n_vms,
              backend=backend.name,
              app_factory=lambda: GangApp(global_rows=global_rows,
                                          iter_time_s=iter_time_s),
              policy=CheckpointPolicy(period_s=0.0, keep_last=keep_last),
              gang=True, min_vms=min_vms,
              # the scenario measures the BARRIER's straggler handling;
              # the monitor's proactive swap-out would race it (two
              # policies fighting over the same degraded host)
              straggler_action="ignore")
    cid = svc.submit(asr)
    try:
        svc.wait_for_state(cid, CoordState.RUNNING, timeout=60)
        svc.trigger_checkpoint(cid)    # first committed gang image exists
        ctrl = ChaosController(svc, cid, backend, schedule, store=store,
                               settle_timeout_s=settle_timeout_s)
        outcomes = ctrl.run()
        coord = svc.db.get(cid)
        return ScenarioResult(
            seed=schedule.seed,
            trace=[o.trace_key() for o in outcomes],
            sim_faults=list(ctrl.sim_faults),
            outcomes=outcomes,
            final_state=coord.state.value,
            recoveries=coord.recoveries,
            events_deduped=svc.apps.events_deduped,
            partition_fallbacks=svc.apps.monitor.partition_fallbacks)
    finally:
        svc.shutdown()
