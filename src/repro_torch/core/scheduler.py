"""Cloud-spanning over-subscription scheduler (paper use case 2 / §2.2(4)).

The paper's second stated purpose is "the administrative capability to
manage an over-subscribed cloud by temporarily swapping out jobs when
higher priority jobs arrive" — the backfill-lease pattern of Marshall et
al. [MKF11]. One :class:`GlobalScheduler` now spans *every* registered
cloud backend:

  * **placement scorer** — candidate clouds are ranked by home-cloud
    affinity (``ASR.backend``), free capacity, and per-cloud *replication
    warmth* (``replication_stats`` / the cloud store's committed images):
    a cloud already holding the newest fully replicated image of a job
    can resume it with zero chunk re-uploads.
  * **preemptive swap-out** — when a higher-priority job cannot fit, the
    lowest-priority RUNNING jobs are checkpointed to stable storage and
    their VMs released. Preemption is all-or-nothing: if any victim's
    swap-out fails, already-suspended victims are resumed (no stranded
    work).
  * **cross-cloud backfill** — a swapped-out job whose images are fully
    replicated on another cloud resumes there through the
    prefix-adoption path (`core/replication.py`): the coordinator's home
    backend and checkpoint store are retargeted, the cached async writer
    dropped, and the restore reads only pre-replicated chunks — zero
    re-uploads across the inter-cloud link.
  * **aging anti-starvation** — a job's effective priority grows with its
    queue wait (``aging_rate`` priority units per second on the injected
    clock), so low-priority work eventually outranks — and may preempt —
    long-running higher-priority jobs instead of starving.
  * **queue persistence** — submissions are admitted as persisted QUEUED
    coordinator records (``CoordinatorDB``), so queued and swapped work
    survives a service restart; a fresh scheduler adopts them.

Scheduling passes are **event-driven**: capacity-freed / fault events
from the cluster simulator, submissions, and image-replication
completions all kick the scheduler (a coarse heartbeat only re-evaluates
aging). Every blocking ``suspend`` / ``resume`` / ``submit`` /
``restart_from`` call runs *outside* the scheduler lock — the same
hold-a-lock-across-a-save hazard ``AppManager.suspend`` avoids — and ``lock_held()`` lets tests verify it.

Every decision is appended to a wall-clock-free *decision trace*
(``decision_trace()``): same seed → identical trace across runs, which is
what `tests/test_scheduler_chaos.py` holds it to.

Port of ``repro/core/scheduler.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.ckpt.reader import list_steps, load_manifest
from repro_torch.core.coordinator import ASR, Coordinator, CoordState
from repro_torch.obs.trace import tracer
from repro_torch.sim.simtime import active_clock

# per-instance registry namespace (sched1.*, sched2.* …) — creation order,
# never hash order, so metric names replay deterministically in-process
_SCHED_SEQ = itertools.count(1)


class _RegCounter:
    """Scheduler counter stored in the metrics registry.

    Keeps the public attribute contract (``sched.preemptions`` reads as an
    int, supports ``+=`` and assignment) while the value itself lives in
    the registry the instance was created under — ``stats()`` is then a
    thin view over telemetry, not a parallel book. NOTE: disabling that
    registry freezes these counters (the overhead benchmark only disables
    a fresh registry around pure ckpt calls, never around a scheduler).
    """

    def __set_name__(self, owner, name):
        self._name = name

    def _counter(self, obj):
        return obj._obs_reg.counter(f"sched.{obj._obs_tag}.{self._name}")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        v = self._counter(obj).value
        return int(v) if float(v).is_integer() else v

    def __set__(self, obj, value):
        self._counter(obj).value = value


class WallClock:
    """Default scheduler clock (monotonic wall seconds). Chaos scenarios
    inject :class:`repro_torch.core.chaos.VirtualClock` instead so queue
    timestamps and aging run in TIME_SCALE-compressed virtual seconds and
    replay bit-for-bit.  When a virtual clock is installed process-wide
    (repro_torch.sim), the scheduler defaults to it instead — see
    ``GlobalScheduler.__init__``."""

    def now(self) -> float:
        return time.monotonic()


@dataclasses.dataclass(frozen=True)
class PlacementWeights:
    """Knobs of the placement scorer (higher score wins; ties resolve to
    the home cloud, then stable name order)."""
    affinity: float = 1.0        # the ASR's home backend
    warmth: float = 2.0          # newest image fully replicated there
    free: float = 0.5            # × fraction of the cloud's hosts idle
    preempt_penalty: float = 0.25   # × victims a preemptive placement needs


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job of a seeded workload trace."""
    name: str
    arrival_s: float             # virtual seconds after trace start
    n_vms: int
    priority: int
    duration_iters: int          # app iterations to completion
    backend: str                 # home cloud (placement affinity)


@dataclasses.dataclass
class WorkloadTrace:
    """Seeded over-subscription workload: same seed → same jobs, always.

    `benchmarks/oversubscription.py` replays one trace through the
    cloud-spanning scheduler and a single-cloud baseline; the property
    suite draws whole traces per hypothesis example."""
    seed: int
    jobs: List[JobSpec]

    @classmethod
    def generate(cls, seed: int, n_jobs: int = 12, *,
                 backends: Tuple[str, ...] = ("cloud",),
                 horizon_s: float = 10.0, max_vms: int = 4,
                 max_priority: int = 9, min_iters: int = 3,
                 max_iters: int = 10) -> "WorkloadTrace":
        rng = random.Random(seed)
        arrivals = sorted(round(rng.uniform(0.0, horizon_s), 3)
                          for _ in range(n_jobs))
        jobs = [JobSpec(name=f"job-{i:03d}", arrival_s=t,
                        n_vms=rng.randint(1, max_vms),
                        priority=rng.randint(0, max_priority),
                        duration_iters=rng.randint(min_iters, max_iters),
                        backend=rng.choice(list(backends)))
                for i, t in enumerate(arrivals)]
        return cls(seed=seed, jobs=jobs)


class GlobalScheduler:
    # decision counters — registry-backed views (see _RegCounter): the
    # attribute reads/writes below behave like plain ints, but the live
    # value sits in the metrics registry under sched.<tag>.<name>
    preemptions = _RegCounter()
    aborted_preemptions = _RegCounter()
    resumes = _RegCounter()
    backfills = _RegCounter()
    backfill_reuploads = _RegCounter()
    requeues = _RegCounter()
    capacity_races = _RegCounter()
    shrinks = _RegCounter()
    tick_errors = _RegCounter()

    def __init__(self, service, *, clock=None,
                 cloud_stores: Optional[Dict[str, str]] = None,
                 aging_rate: float = 0.0, tick_s: float = 0.25,
                 weights: PlacementWeights = PlacementWeights()):
        """``cloud_stores`` maps backend name → the named store
        (``CheckpointManager``) that cloud checkpoints to; placement onto
        a cloud retargets the job's ``CheckpointPolicy.store`` there.
        ``aging_rate`` is effective-priority units per (injected-clock)
        second of queue wait; 0 disables aging."""
        self.service = service
        # explicit clock wins; otherwise the process-wide installed clock
        # (WallClock in production, SimClock under the virtual-time fixture)
        self.clock = clock or active_clock()
        self.cloud_stores = {name: "default"
                             for name in service.cloud.backends()}
        self.cloud_stores.update(cloud_stores or {})
        self.aging_rate = aging_rate
        self.tick_s = tick_s
        self.weights = weights
        self._lock = threading.Lock()      # planning state only — never
        self._held = threading.local()     # held across a blocking call
        self._tick_mutex = threading.Lock()   # one pass at a time
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tlock = threading.Lock()
        self._seq = 0
        self._trace: List[Tuple] = []
        # capacity reservations for placements dispatched but not yet
        # allocated: bring-ups run concurrently on the app manager's
        # background pool (paper §6.5), so the planner must not hand the
        # same free hosts to two jobs. coord_id -> (backend, n_vms); a
        # reservation stops counting against free capacity the moment the
        # coordinator's VMs are assigned (the backend's own capacity then
        # reflects the claim — counting both would double-book).
        self._rlock = threading.Lock()
        self._reserved: Dict[str, Tuple[str, int]] = {}
        # registry-backed counters (_RegCounter descriptors): bind this
        # instance's namespace before the zeroing assignments below
        from repro_torch.obs.telemetry import registry as _registry
        self._obs_reg = _registry()
        self._obs_tag = f"sched{next(_SCHED_SEQ)}"
        self.preemptions = 0
        self.aborted_preemptions = 0
        self.resumes = 0
        self.backfills = 0               # cross-cloud resumes/restarts
        self.backfill_reuploads = 0      # chunks a backfill had to ship (0!)
        self.requeues = 0                # dead-cloud jobs sent back to queue
        self.capacity_races = 0          # placements aborted back to queue
        self.shrinks = 0                 # gang jobs placed below full size
        self.tick_errors = 0
        self._subscribe()
        self._adopt_existing()

    # ------------------------------------------------------------------
    # lock discipline
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _locked(self):
        with self._lock:
            self._held.flag = True
            try:
                yield
            finally:
                self._held.flag = False

    def lock_held(self) -> bool:
        """True iff the *calling thread* holds the scheduler lock. Every
        blocking service call the scheduler makes asserts this is False."""
        return getattr(self._held, "flag", False)

    def _assert_unlocked(self) -> None:
        if self.lock_held():
            raise AssertionError(
                "blocking scheduler action attempted under the scheduler "
                "lock (suspend/resume/submit must run outside it)")

    # ------------------------------------------------------------------
    # event wiring
    # ------------------------------------------------------------------
    def _subscribe(self) -> None:
        for backend in self.service.cloud.backends().values():
            sim = getattr(backend, "sim", None)
            if sim is None:
                continue
            if hasattr(sim, "on_capacity"):
                sim.on_capacity(lambda: self.kick("capacity"))
            if hasattr(sim, "on_fault"):
                sim.on_fault(lambda *_: self.kick("fault"))
            if hasattr(sim, "on_allocation"):
                sim.on_allocation(lambda owner, n: self._mark_allocated(owner))
        rep = getattr(self.service, "replicator", None)
        if rep is not None and hasattr(rep, "on_replicated"):
            rep.on_replicated(lambda *_: self.kick("replicated"))

    def _adopt_existing(self) -> None:
        """Adopt rehydrated / pre-existing QUEUED and SUSPENDED records
        into the queue (service restart: the persisted queue comes back
        through ``CoordinatorDB.load``)."""
        now = self.clock.now()
        for coord in self.service.db.list():
            if coord.state in (CoordState.QUEUED, CoordState.SUSPENDED):
                coord.metrics.setdefault("queued_at_v", now)

    def kick(self, reason: str = "") -> None:
        """Request a scheduling pass (non-blocking; safe from any
        thread/callback). Capacity events, faults, submissions and
        replication completions all land here."""
        self._wake.set()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="gsched")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            # event-driven: woken by capacity/fault/submit/replication
            # events; tick_s is only the aging-re-evaluation heartbeat
            active_clock().wait(self._wake, self.tick_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:                  # noqa: BLE001
                self.tick_errors += 1

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, asr: ASR, *,
               adopt_prefix: Optional[str] = None) -> str:
        """Admit a job: a persisted QUEUED coordinator record is created
        immediately (it survives restarts) and a scheduling pass decides
        when and *where* it actually starts. Returns the coord_id; poll
        its state (QUEUED until placed).

        ``adopt_prefix`` sets the job's checkpoint *read* adoption before
        the first scheduling pass can race it: a serving-fleet replica
        submitted against a seed lineage restores that shared image on
        cold start (zero re-uploads) while its own saves stay private —
        see ``Coordinator.ckpt_adopt_prefix``."""
        coord = self.service.apps.enqueue(asr)
        if adopt_prefix:
            coord.ckpt_adopt_prefix = adopt_prefix
        coord.metrics["queued_at_v"] = self.clock.now()
        self.service.db.persist(coord)
        self._record("submit", coord, asr.backend)
        self.nudge("submit")
        return coord.coord_id

    def nudge(self, reason: str = "") -> None:
        """Request a pass the way submit() does: synchronous tick when no
        loop thread is running (tests/tools), event kick otherwise. For
        external queue mutations — e.g. a FleetController unparking a
        suspended replica."""
        if self._thread is None:
            self.tick()
        else:
            self.kick(reason)

    # ------------------------------------------------------------------
    # scheduling pass
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One scheduling pass: order the queue under the lock (pure
        in-memory state — store I/O and every blocking call run outside
        it), dispatch each decision, repeat until nothing places.
        Placements of different jobs run concurrently on the app
        manager's pool behind capacity reservations; preemptive swap-outs
        run synchronously here (their all-or-nothing rollback needs to
        finish before the beneficiary starts). Returns the number of
        actions dispatched."""
        with tracer().span("sched/tick", cat="sched") as sp:
            done = self._tick_inner()
            sp.set("actions", done)
        return done

    def _tick_inner(self) -> int:
        done = 0
        with self._tick_mutex:
            while True:
                with self._locked():
                    requeue, waiting = self._plan()
                action = requeue
                if action is None:
                    for c in waiting:      # placement reads stores: outside
                        action = self._place(c)      # the scheduler lock
                        if action is not None:
                            break
                if action is None:
                    return done
                if not self._execute(action):
                    return done            # blocked/raced: retry next pass
                done += 1

    def effective_priority(self, coord: Coordinator) -> int:
        """A waiter's priority: base + accrued queue-wait aging."""
        base = coord.asr.priority
        queued_at = coord.metrics.get("queued_at_v")
        if queued_at is None or self.aging_rate <= 0:
            return base
        wait = max(0.0, self.clock.now() - queued_at)
        return base + int(self.aging_rate * wait)

    def defense_priority(self, coord: Coordinator) -> int:
        """A runner's priority against preemption: base + the age credit
        it held when it was placed. Without the credit, an aged-up job
        that finally won capacity would be preempted right back by the
        higher-base-priority job it outranked — aging would be
        self-defeating. With ``aging_rate == 0`` this is just the base."""
        return coord.asr.priority + int(coord.metrics.get("prio_boost", 0))

    def _plan(self) -> Tuple[Optional[Dict[str, Any]], List[Coordinator]]:
        """Queue bookkeeping + ordering (in-memory only, runs under the
        scheduler lock): returns a requeue action (dead-cloud job) or the
        effective-priority-ordered waiting list for placement."""
        coords = self.service.db.list()
        now = self.clock.now()
        for c in coords:
            # adopt monitor-suspended (straggler) and rehydrated work
            if c.state in (CoordState.QUEUED, CoordState.SUSPENDED):
                c.metrics.setdefault("queued_at_v", now)
        for c in coords:
            if c.state == CoordState.ERROR and self._cloud_dead(c):
                return {"op": "requeue", "coord": c}, []
        with self._rlock:
            inflight = set(self._reserved)
        # fleet-parked replicas (scale-in suspends, serve/fleet.py) are
        # deliberately swapped out to hand their hosts to batch work —
        # auto-resuming them here would undo the reclaim; only their
        # FleetController unparks them (clearing the flag) on scale-out
        waiting = [c for c in coords
                   if c.state in (CoordState.QUEUED, CoordState.SUSPENDED)
                   and c.coord_id not in inflight
                   and not (c.state == CoordState.SUSPENDED
                            and c.metrics.get("fleet_parked"))]
        waiting.sort(key=lambda c: (-self.effective_priority(c),
                                    c.metrics.get("queued_at_v", 0.0),
                                    c.asr.name, c.coord_id))
        return None, waiting

    def _cloud_dead(self, coord: Coordinator) -> bool:
        """Conclusive home-cloud loss for a managed job — the
        FailoverController trigger adapted in-service: ERROR (recovery
        exhausted at home), the old fleet fully dark, zero spare
        capacity. Requeued jobs wait for a warm standby or a heal."""
        if coord.vms and any(vm.reachable for vm in coord.vms):
            return False
        try:
            if self.service.cloud.capacity(coord.asr.backend) > 0:
                return False               # the home cloud can still recover
        except Exception:                  # noqa: BLE001
            pass                           # unreachable backend == down
        if coord.vms and not self.service.apps.monitor.fleet_unreachable(
                coord.coord_id):
            return False                   # e.g. ERROR from an app bug
        return True

    # ---- placement -----------------------------------------------------
    def _allowed(self, asr: ASR) -> List[str]:
        names = [n for n in self.service.cloud.backends()
                 if not asr.clouds or n in asr.clouds]
        names.sort(key=lambda n: (n != asr.backend, n))   # home first
        return names

    def _home_latest(self, coord: Coordinator) -> Optional[int]:
        try:
            return self.service.ckpt.latest(coord)
        except Exception:                  # noqa: BLE001
            return None                    # home store unreachable

    def _read_prefix(self, coord: Coordinator, store) -> str:
        """The prefix a restore on ``store`` would read: the job's own
        prefix when it holds images there, else its adopt prefix (fleet
        replicas restoring a replicated seed lineage on another cloud
        pass the zero-re-upload gate through the seed's replicas)."""
        adopt = coord.ckpt_adopt_prefix
        if adopt and not list_steps(store, coord.ckpt_prefix):
            return adopt
        return coord.ckpt_prefix

    def _warm_step(self, coord: Coordinator, backend: str) -> Optional[int]:
        """Newest step COMMITTED in ``backend``'s store under this job's
        read prefix — what a resume there could restore without any
        upload."""
        try:
            store = self.service.ckpt.store(
                self.cloud_stores.get(backend, "default"))
            steps = list_steps(store, self._read_prefix(coord, store))
        except Exception:                  # noqa: BLE001
            return None
        return steps[-1] if steps else None

    def _replication_warmth(self, coord: Coordinator) -> Dict[str, float]:
        """backend → warmth in [0, 1] from the attached replicator's
        ``replication_stats`` (lag_images == 0 → fully warm; a partial
        replica scores half — resumable only after the backlog drains)."""
        rep = getattr(self.service, "replicator", None)
        if rep is None:
            return {}
        try:
            stats = self.service.replication_stats(coord.coord_id)
        except Exception:                  # noqa: BLE001
            return {}
        out: Dict[str, float] = {}
        for name, t in (stats.get("targets") or {}).items():
            try:
                backend = rep.target(name).backend
            except Exception:              # noqa: BLE001
                backend = None
            if backend:
                out[backend] = (1.0 if t.get("lag_images") == 0
                                else 0.5 if t.get("last_step") is not None
                                else 0.0)
        return out

    def _mark_allocated(self, coord_id: str) -> None:
        """Allocation-claim event (``ClusterSim.on_allocation``): the
        backend's capacity counters now carry this job's hosts, so its
        reservation must stop counting — keeping both would double-book
        the hosts for the whole simulated boot."""
        with self._rlock:
            entry = self._reserved.get(coord_id)
            if entry is not None:
                self._reserved[coord_id] = (entry[0], 0)

    def _free(self, backend: str) -> int:
        try:
            free = self.service.cloud.capacity(backend)
        except Exception:                  # noqa: BLE001
            return 0
        with self._rlock:
            pending = [(cid, n) for cid, (b, n) in self._reserved.items()
                       if b == backend and n > 0]
        for cid, n in pending:
            try:
                coord = self.service.db.get(cid)
            except KeyError:
                continue
            # belt-and-braces for backends without allocation events:
            # once the bring-up has assigned vms, capacity() already
            # accounts for them
            if not coord.vms:
                free -= n
        return max(0, free)

    def _score(self, coord: Coordinator, backend: str, free: int,
               warmth: Dict[str, float], n_victims: int = 0) -> float:
        w = self.weights
        b = self.service.cloud.backend(backend)
        sim = getattr(b, "sim", None)
        total = sim.n_hosts if sim is not None else max(free, 1)
        score = w.free * (free / max(1, total))
        if backend == coord.asr.backend:
            score += w.affinity + w.warmth   # home store holds the lineage
        else:
            score += w.warmth * warmth.get(backend, 0.0)
        return score - w.preempt_penalty * n_victims

    def _place(self, coord: Coordinator) -> Optional[Dict[str, Any]]:
        """Best placement for one waiting job, or None.

        Jobs holding images (SUSPENDED, or QUEUED after a requeue) may
        only go to their home cloud or a cloud whose store holds the
        newest image fully replicated — the zero-re-upload invariant.
        Free-capacity fits are preferred; otherwise the cheapest
        all-or-nothing preemption of strictly-lower-priority work wins
        (waiters attack with their *aged* priority, runners defend with
        ``defense_priority`` — base plus the age credit they were placed
        with; that asymmetry is the anti-starvation)."""
        asr = coord.asr
        home_latest = self._home_latest(coord)
        needs_image = (coord.state == CoordState.SUSPENDED
                       or home_latest is not None)
        warmth = self._replication_warmth(coord) if needs_image else {}
        mode = ("resume" if coord.state == CoordState.SUSPENDED
                else "restart" if needs_image else "fresh")
        candidates: List[Tuple[float, int, str]] = []   # (score, i, name)
        preemptive: List[Tuple[int, float, int, str, List]] = []
        eff = self.effective_priority(coord)
        for i, name in enumerate(self._allowed(asr)):
            if needs_image and name != asr.backend:
                warm = self._warm_step(coord, name)
                if warm is None or (home_latest is not None
                                    and warm < home_latest):
                    continue               # not fully replicated: no backfill
            free = self._free(name)
            if free >= asr.n_vms:
                candidates.append(
                    (self._score(coord, name, free, warmth), -i, name))
                continue
            victims = self._pick_victims(coord, name, free, eff)
            if victims is not None:
                preemptive.append(
                    (len(victims),
                     -self._score(coord, name, free, warmth, len(victims)),
                     i, name, victims))
        if candidates:
            candidates.sort(reverse=True)
            return {"op": "place", "coord": coord, "mode": mode,
                    "backend": candidates[0][2]}
        if preemptive:
            preemptive.sort()              # fewest victims, best score
            _, _, _, name, victims = preemptive[0]
            return {"op": "place", "coord": coord, "mode": mode,
                    "backend": name, "victims": victims}
        # Gang elastic shrink: a gang job that holds a committed gang
        # image can reshard onto fewer ranks than it ran with, so when
        # nothing fits at full size it may claim a smaller free block —
        # but never below min_vms (0 = shrink disabled: full n_vms or
        # nothing), and never without an image (a fresh gang start is
        # all-or-nothing at n_vms).
        if asr.gang and needs_image and 0 < asr.min_vms < asr.n_vms:
            floor = asr.min_vms
            shrunk: List[Tuple[float, int, int, str]] = []
            for i, name in enumerate(self._allowed(asr)):
                if needs_image and name != asr.backend:
                    warm = self._warm_step(coord, name)
                    if warm is None or (home_latest is not None
                                        and warm < home_latest):
                        continue           # zero-re-upload gate still holds
                free = self._free(name)
                if floor <= free < asr.n_vms:
                    shrunk.append((self._score(coord, name, free, warmth),
                                   free, -i, name))
            if shrunk:
                shrunk.sort(reverse=True)
                return {"op": "place", "coord": coord, "mode": mode,
                        "backend": shrunk[0][3], "n_vms": shrunk[0][1]}
        return None

    def _pick_victims(self, coord: Coordinator, backend: str, free: int,
                      eff: int) -> Optional[List[Coordinator]]:
        """Lowest-priority RUNNING jobs on ``backend`` whose (base)
        priority is strictly below the waiter's effective priority, until
        the job fits — or None when even preempting all of them would not
        free enough hosts (then nothing is preempted at all)."""
        running = [c for c in self.service.db.list()
                   if c.state == CoordState.RUNNING
                   and c.asr.backend == backend
                   and self.defense_priority(c) < eff
                   and c.coord_id != coord.coord_id]
        running.sort(key=lambda c: (self.defense_priority(c), c.asr.name,
                                    c.coord_id))
        victims: List[Coordinator] = []
        for c in running:
            if free >= coord.asr.n_vms:
                break
            victims.append(c)
            free += len(c.vms)
        return victims if free >= coord.asr.n_vms else None

    # ------------------------------------------------------------------
    # execution (every blocking call lives below — outside the lock)
    # ------------------------------------------------------------------
    def _execute(self, action: Dict[str, Any]) -> bool:
        self._assert_unlocked()
        try:
            if action["op"] == "requeue":
                return self._exec_requeue(action["coord"])
            victims = action.get("victims")
            if victims and not self._exec_preempt(action["coord"], victims):
                return False
            return self._exec_place(action["coord"], action["backend"],
                                    action["mode"],
                                    n_vms=action.get("n_vms"))
        except Exception:                  # noqa: BLE001
            self._count("tick_errors")
            return False

    def _exec_requeue(self, coord: Coordinator) -> bool:
        self._assert_unlocked()
        # take ownership FIRST: only strip the VM handles once the
        # transition has succeeded under the lock — a concurrent
        # restart_from/terminate that won the record must find its
        # handles intact
        with coord.lock:
            if coord.state != CoordState.ERROR:
                return False
            vms, coord.vms = coord.vms, []
            coord.metrics["queued_at_v"] = self.clock.now()
            self.service.db.transition(coord, CoordState.QUEUED,
                                       "requeue:cloud-dead")
        if vms:
            try:                           # release the dead fleet's handles
                self.service.cloud.destroy_cluster(coord.asr.backend, vms)
            except Exception:              # noqa: BLE001
                pass                       # the cloud is down; best-effort
        self._count("requeues")
        self._record("requeue", coord, coord.asr.backend)
        return True

    def _exec_preempt(self, coord: Coordinator,
                      victims: List[Coordinator]) -> bool:
        """All-or-nothing swap-out: if any victim's suspend fails, the
        already-suspended victims are resumed — a failed preemption must
        not strand work on stable storage with its capacity gone."""
        self._assert_unlocked()
        done: List[Coordinator] = []
        now = self.clock.now()
        try:
            for v in victims:
                self.service.apps.suspend(
                    v.coord_id, reason=f"preempted:{coord.asr.name}")
                self._stamp_queued(v, now)
                done.append(v)
                self._count("preemptions")
                self._record("preempt", v, v.asr.backend, coord.asr.name)
        except Exception:                  # noqa: BLE001
            for v in done:
                try:
                    self.service.apps.resume(v.coord_id, block=True)
                except Exception:          # noqa: BLE001
                    pass                   # stays SUSPENDED; queued for later
            self._count("aborted_preemptions")
            self._record("preempt_abort", coord, "",
                         ",".join(v.asr.name for v in victims))
            return False
        return True

    def _exec_place(self, coord: Coordinator, backend: str,
                    mode: str, n_vms: Optional[int] = None) -> bool:
        """Dispatch one placement. The decision (retarget, reservation,
        trace entry) is taken here in planning order — deterministic —
        while the blocking bring-up/restore runs on the app manager's
        background pool, so placements of different jobs overlap."""
        self._assert_unlocked()
        # lock in the age credit this placement was won with (see
        # defense_priority); overwritten on every placement, never stacked
        coord.metrics["prio_boost"] = max(
            0, self.effective_priority(coord) - coord.asr.priority)
        cross = backend != coord.asr.backend
        # remembered for rollback: a cross placement that loses the
        # capacity race must return home, or the job is silently rehomed
        prev = (coord.asr.backend, coord.asr.policy.store)
        if cross:
            if mode in ("resume", "restart"):
                reuploads = self._missing_chunks(coord, backend)
                coord.metrics["backfill_reuploads"] = reuploads
                self._count("backfill_reuploads", reuploads)
            self._retarget(coord, backend)
        op = ("backfill" if cross and mode != "fresh"
              else {"fresh": "start", "resume": "resume",
                    "restart": "restart"}[mode])
        self._record(op, coord, backend)
        if n_vms is not None and n_vms < coord.asr.n_vms:
            # elastic gang shrink: remember the full size (a later grow
            # pass can restore it), then place at the surviving count —
            # restart_from/resume allocate coord.asr.n_vms, so the
            # override must land before the reservation and dispatch
            coord.metrics.setdefault("gang_full_vms", coord.asr.n_vms)
            coord.asr.n_vms = n_vms
            self._count("shrinks")
            self._record("shrink", coord, backend,
                         f"{n_vms}/{coord.metrics['gang_full_vms']}")
        with self._rlock:
            self._reserved[coord.coord_id] = (backend, coord.asr.n_vms)

        def run() -> None:
            try:
                if mode == "fresh":
                    self._finish_start(coord, backend)
                elif mode == "resume":
                    self._finish_resume(coord, cross, prev)
                else:
                    self._finish_restart(coord, cross, prev)
            except Exception:              # noqa: BLE001
                self._count("tick_errors")
            finally:
                with self._rlock:
                    self._reserved.pop(coord.coord_id, None)
                self.kick("placed")

        self.service.apps.pool.submit(run)
        return True

    def _finish_start(self, coord: Coordinator, backend: str) -> None:
        try:
            self.service.apps.start_queued(coord.coord_id, block=True)
        except RuntimeError:
            return                         # state raced (e.g. terminated)
        if coord.state == CoordState.ERROR:
            if "CapacityError" in (coord.error or ""):
                # capacity raced away between plan and claim: back to the
                # queue (keeping its original wait stamp would double-age)
                with coord.lock:
                    if coord.state == CoordState.ERROR:
                        self.service.db.transition(
                            coord, CoordState.QUEUED, "capacity race")
                self._stamp_queued(coord)
                self._count("capacity_races")
            else:
                self._record("start_failed", coord, backend)

    def _finish_resume(self, coord: Coordinator, cross: bool,
                       prev: Tuple[str, str]) -> None:
        try:
            self.service.apps.resume(coord.coord_id, block=True)
        except RuntimeError:
            self._rollback_retarget(coord, cross, prev)
            return
        if coord.state == CoordState.SUSPENDED:
            self._rollback_retarget(coord, cross, prev)
            self._count("capacity_races")  # fell back to stable storage
            return
        if coord.state != CoordState.RUNNING:
            return
        self._count("resumes")
        if cross:
            self._count("backfills")

    def _finish_restart(self, coord: Coordinator, cross: bool,
                        prev: Tuple[str, str]) -> None:
        try:
            self.service.apps.restart_from(coord.coord_id)
        except Exception as e:             # noqa: BLE001
            # restart_from raises on allocation races; the job still
            # holds its images — park it SUSPENDED for a later pass
            with coord.lock:
                if coord.state == CoordState.RESTARTING:
                    self.service.db.transition(
                        coord, CoordState.SUSPENDED,
                        f"restart aborted: {type(e).__name__}")
            self._rollback_retarget(coord, cross, prev)
            self._stamp_queued(coord)
            self._count("capacity_races")
            return
        if coord.state != CoordState.RUNNING:
            return
        self._count("resumes")
        if cross:
            self._count("backfills")

    def _count(self, counter: str, n: int = 1) -> None:
        with self._rlock:
            setattr(self, counter, getattr(self, counter) + n)

    def _stamp_queued(self, coord: Coordinator,
                      now: Optional[float] = None) -> None:
        """(Re-)stamp a job's queue-entry time AND persist the record —
        aging must resume from the accrued wait after a service restart,
        not from zero."""
        coord.metrics["queued_at_v"] = (self.clock.now()
                                        if now is None else now)
        try:
            self.service.db.persist(coord)
        except Exception:                  # noqa: BLE001
            pass                           # persistence store unreachable

    def _retarget(self, coord: Coordinator, backend: str,
                  store: Optional[str] = None) -> None:
        """Move a coordinator's home to another cloud: swap the ASR's
        backend and checkpoint store to the target's and drop the cached
        async writer (bound to the old store). The checkpoint prefix is
        unchanged — the restore adopts the replica the ImageReplicator
        already committed there (prefix adoption), and
        post-backfill saves continue the lineage on the new store."""
        self.service.ckpt.detach(coord.coord_id)
        coord.asr.backend = backend
        coord.asr.policy.store = (store if store is not None
                                  else self.cloud_stores.get(backend,
                                                             "default"))

    def _rollback_retarget(self, coord: Coordinator, cross: bool,
                           prev: Tuple[str, str]) -> None:
        """Undo a cross-cloud retarget whose placement failed: the job
        returns home (original backend + store), so the eventual retry
        re-evaluates placement — and counts as a backfill — correctly."""
        if cross:
            self._retarget(coord, prev[0], store=prev[1])

    def _missing_chunks(self, coord: Coordinator, backend: str) -> int:
        """Chunks of the newest replicated image NOT already present in
        the target cloud's store — what a backfill would have to ship
        across the inter-cloud link (0 == the pure replica-hit path)."""
        try:
            store = self.service.ckpt.store(
                self.cloud_stores.get(backend, "default"))
            prefix = self._read_prefix(coord, store)
            steps = list_steps(store, prefix)
            if not steps:
                return 0
            man = load_manifest(store, prefix, steps[-1])
        except Exception:                  # noqa: BLE001
            return 0
        keys = {c.key for li in man.leaves.values() for c in li.chunks}
        return sum(1 for k in keys if not store.exists(k))

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def _record(self, op: str, coord: Coordinator, backend: str,
                detail: str = "") -> None:
        with self._tlock:
            self._seq += 1
            seq = self._seq
            self._trace.append((seq, op, coord.asr.name, backend,
                                detail, coord.trace_id))
        # mirror each decision into the span tracer so a job's placement
        # correlates with its ckpt/monitor spans by trace_id; the local
        # tuple list above stays the replay-exact source of truth for
        # decision_trace() (the tracer has a drop cap, this list doesn't)
        tracer().event(f"sched/{op}", cat="sched", trace_id=coord.trace_id,
                       args={"seq": seq, "job": coord.asr.name,
                             "backend": backend, "detail": detail})

    def decision_trace(self) -> List[Tuple]:
        """Wall-clock-free decision log: (seq, op, job name, backend,
        detail, trace_id). Two runs of the same seeded scenario must
        produce the same trace — the determinism contract; trace_id is
        derived from the DB creation sequence, so it replays too."""
        with self._tlock:
            return list(self._trace)

    @property
    def queue_depth(self) -> int:
        """QUEUED records not yet dispatched (in-flight bring-ups are no
        longer waiting — they hold a capacity reservation)."""
        with self._rlock:
            inflight = set(self._reserved)
        return sum(1 for c in self.service.db.list()
                   if c.state == CoordState.QUEUED
                   and c.coord_id not in inflight)

    @property
    def inflight_depth(self) -> int:
        """Placements dispatched but not yet completed."""
        with self._rlock:
            return len(self._reserved)

    def stats(self) -> Dict[str, Any]:
        return {
            "queue_depth": self.queue_depth,
            "preemptions": self.preemptions,
            "aborted_preemptions": self.aborted_preemptions,
            "resumes": self.resumes,
            "backfills": self.backfills,
            "backfill_reuploads": self.backfill_reuploads,
            "requeues": self.requeues,
            "capacity_races": self.capacity_races,
            "shrinks": self.shrinks,
            "tick_errors": self.tick_errors,
        }
