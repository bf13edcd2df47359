"""Pure single-threaded discrete-event cluster simulation.

``SimClock`` (repro_torch.sim.simtime) makes the *threaded* control plane
run on virtual time; this module is the complementary piece for scale: a
deterministic engine that replays the paper's scheduling story — arrivals,
boot costs, periodic checkpoints, host faults with checkpoint-bounded
rollback, priority preemption with aging — over thousands of hosts and a
simulated week in seconds of wall time, with a byte-identical event trace
for a given seed.

Everything is driven off one :class:`~repro_torch.sim.simtime.EventQueue`
(``(time, seq)`` ordering, FIFO tie-break); the only randomness is a
``random.Random(seed)`` stream; no dict/set iteration order reaches the
trace — so two fresh processes with different ``PYTHONHASHSEED`` produce
the same bytes.

Scheduler semantics deliberately mirror ``core/scheduler.py``'s
GlobalScheduler invariants (capacity safety, priority + aging, preempt
only strictly-lower priority and only when it actually makes the job fit,
FIFO among equals), so the soak test exercises the same policy shape the
property suite checks on the real implementation.

Because aging is uniform (``eff = pri + rate * (now - queued_at)``), the
*relative* order of two waiters never changes while both wait — the
``rate * now`` term is common to both.  The wait queue is therefore kept
as a bisect-maintained sorted list keyed by ``rate * queued_at - pri``
that never needs re-sorting, which is what keeps a congested week-long
trace near-linear in the number of events.

Port of ``repro/sim/engine.py``.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import heapq
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.sim.simtime import Event, EventQueue

QUEUED, BOOTING, RUNNING, DONE = range(4)

_MAX_PRI = 9
_MAX_VMS = 8


@dataclasses.dataclass
class SimJob:
    jid: int
    arrival_s: float
    n_vms: int
    priority: int
    work_s: float                       # total compute to finish
    ckpt_period_s: float
    boot_s: float                       # allocate + provision cost
    restore_s: float                    # checkpoint restore cost
    state: int = QUEUED
    remaining_s: float = 0.0            # work left at last (re)start
    saved_s: float = 0.0                # progress protected by a checkpoint
    started_at: float = 0.0             # virtual time the current run began
    queued_at: float = 0.0
    hosts: Tuple[int, ...] = ()
    boot_ev: Optional[Event] = None
    run_ev: Optional[Event] = None
    ckpt_ev: Optional[Event] = None
    preemptions: int = 0
    recoveries: int = 0
    finished_at: float = -1.0

    def progress_now(self, now: float) -> float:
        done = self.work_s - self.remaining_s
        if self.state == RUNNING:
            done += now - self.started_at
        return min(done, self.work_s)


class InvariantViolation(AssertionError):
    pass


class SimEngine:
    """Seeded cluster + workload + fault process over an EventQueue.

    Usage::

        eng = SimEngine(n_hosts=1000, seed=7)
        eng.load(n_jobs=10_000, horizon_s=7 * 86400.0)
        eng.run()
        eng.trace_digest()   # byte-identical for identical (args, seed)
    """

    #: run the full O(jobs) cross-check every this many events (the O(1)
    #: counter check runs on every single event)
    DEEP_CHECK_EVERY = 1000

    def __init__(self, n_hosts: int, seed: int, *,
                 aging_rate: float = 1.0 / 600.0,
                 host_mtbf_s: float = 0.0):
        self.n_hosts = n_hosts
        self.seed = seed
        self.aging_rate = aging_rate
        self.host_mtbf_s = host_mtbf_s
        self.rng = random.Random(seed)
        self.q = EventQueue()
        self.now = 0.0
        self.jobs: List[SimJob] = []
        self.free: List[int] = list(range(n_hosts))     # min-heap
        self.used = 0
        self.host_job: Dict[int, int] = {}              # host -> jid
        # wait queue: sorted (age_key, jid); age_key = rate*queued_at - pri,
        # ascending == highest effective priority first (see module doc)
        self.waiting: List[Tuple[float, int]] = []
        self.wait_pri_count = [0] * (_MAX_PRI + 1)      # by raw priority
        self.wait_vms_count = [0] * (_MAX_VMS + 1)      # by VM ask
        self.running: List[int] = []                    # jids, unordered
        self.trace: List[str] = []
        self.completed = 0
        self.preemptions = 0
        self.recoveries = 0
        self.max_wait_s = 0.0
        self.events_fired = 0
        self.sched_scans = 0                            # observability

    # ---- workload generation -------------------------------------------
    def load(self, n_jobs: int, horizon_s: float, *,
             arrival_horizon_s: Optional[float] = None,
             max_vms: int = _MAX_VMS, mean_work_s: float = 3600.0,
             ckpt_period_s: float = 900.0,
             boot_s: float = 30.0, restore_s: float = 60.0,
             max_priority: int = _MAX_PRI) -> None:
        """Seeded open arrivals (uniform order statistics — deterministic
        for the seed).  ``arrival_horizon_s`` (default: ``horizon_s``)
        bounds *arrivals*; host faults span the full ``horizon_s`` — pack
        arrivals into a shorter window to create over-subscription.
        ``max_priority`` caps the drawn priorities — a workload sharing
        the cluster with always-on serving replicas (sim/serve.py pins
        those at ``_MAX_PRI``) draws batch jobs strictly below them."""
        if not 1 <= max_priority <= _MAX_PRI:
            raise ValueError(f"max_priority must be in [1, {_MAX_PRI}]")
        span = arrival_horizon_s or horizon_s
        arrivals = sorted(self.rng.uniform(0.0, span) for _ in range(n_jobs))
        base = len(self.jobs)
        for i, at in enumerate(arrivals):
            job = SimJob(
                jid=base + i, arrival_s=at,
                n_vms=self.rng.randint(1, max_vms),
                priority=self.rng.randint(1, max_priority),
                work_s=self.rng.expovariate(1.0 / mean_work_s) + 60.0,
                ckpt_period_s=ckpt_period_s,
                boot_s=boot_s, restore_s=restore_s)
            job.remaining_s = job.work_s
            self.jobs.append(job)
            self.q.schedule(at, "arrive", job.jid)
        if self.host_mtbf_s > 0:
            # one Poisson fault process for the whole fleet
            rate = self.n_hosts / self.host_mtbf_s
            t = self.rng.expovariate(rate)
            while t < horizon_s:
                self.q.schedule(t, "fault", self.rng.randrange(self.n_hosts))
                t += self.rng.expovariate(rate)

    # ---- event loop -----------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        while True:
            ev = self.q.pop()
            if ev is None:
                break
            if until is not None and ev.time > until:
                break
            self.now = ev.time
            self.events_fired += 1
            getattr(self, f"_on_{ev.kind}")(ev)
            if self.used + len(self.free) != self.n_hosts:
                raise InvariantViolation(
                    f"t={self.now}: {self.used} used + {len(self.free)} "
                    f"free != {self.n_hosts} hosts")
            if self.events_fired % self.DEEP_CHECK_EVERY == 0:
                self.check_invariants()
        self.check_invariants()

    def _emit(self, kind: str, detail: str) -> None:
        self.trace.append(f"{self.now:.6f} {kind} {detail}")

    # ---- wait-queue bookkeeping -----------------------------------------
    def _enqueue(self, job: SimJob) -> None:
        job.state = QUEUED
        job.queued_at = self.now
        key = self.aging_rate * job.queued_at - job.priority
        bisect.insort(self.waiting, (key, job.jid))
        self.wait_pri_count[job.priority] += 1
        self.wait_vms_count[job.n_vms] += 1

    def _min_wait_vms(self) -> int:
        for vms in range(1, _MAX_VMS + 1):
            if self.wait_vms_count[vms]:
                return vms
        return _MAX_VMS + 1

    # ---- handlers -------------------------------------------------------
    def _on_arrive(self, ev: Event) -> None:
        job = self.jobs[ev.payload]
        self._enqueue(job)
        self._emit("arrive", f"j{job.jid} vms={job.n_vms} pri={job.priority}")
        self._schedule_queue()

    def _on_boot_done(self, ev: Event) -> None:
        job = self.jobs[ev.payload]
        if job.state != BOOTING:
            return
        job.boot_ev = None
        job.state = RUNNING
        job.started_at = self.now
        self.running.append(job.jid)
        job.run_ev = self.q.schedule(self.now + job.remaining_s,
                                     "run_done", job.jid)
        if job.ckpt_period_s > 0:
            job.ckpt_ev = self.q.schedule(self.now + job.ckpt_period_s,
                                          "ckpt", job.jid)
        self._emit("start", f"j{job.jid} hosts={len(job.hosts)}")

    def _on_ckpt(self, ev: Event) -> None:
        job = self.jobs[ev.payload]
        if job.state != RUNNING:
            return
        job.saved_s = job.progress_now(self.now)
        job.ckpt_ev = self.q.schedule(self.now + job.ckpt_period_s,
                                      "ckpt", job.jid)
        self._emit("ckpt", f"j{job.jid} saved={job.saved_s:.3f}")

    def _on_run_done(self, ev: Event) -> None:
        job = self.jobs[ev.payload]
        if job.state != RUNNING:
            return
        job.run_ev = None
        job.remaining_s = 0.0
        self.running.remove(job.jid)
        self._release(job)
        job.state = DONE
        job.finished_at = self.now
        self.completed += 1
        wait = max(0.0, (self.now - job.arrival_s) - job.work_s - job.boot_s)
        self.max_wait_s = max(self.max_wait_s, wait)
        self._emit("done", f"j{job.jid}")
        self._schedule_queue()

    def _on_fault(self, ev: Event) -> None:
        host = ev.payload
        jid = self.host_job.get(host)
        if jid is None:
            self._emit("fault", f"h{host} idle")
            return
        job = self.jobs[jid]
        lost = job.progress_now(self.now) - job.saved_s
        self._halt(job)
        # roll back to the last checkpoint: progress past saved_s is lost
        job.remaining_s = job.work_s - job.saved_s
        job.recoveries += 1
        self.recoveries += 1
        self._enqueue(job)
        self._emit("fault", f"h{host} j{job.jid} lost={lost:.3f}")
        self._schedule_queue()

    # ---- allocation -----------------------------------------------------
    def _halt(self, job: SimJob) -> None:
        """Stop a running/booting job, cancelling its pending events."""
        if job.boot_ev is not None:
            self.q.cancel(job.boot_ev)
            job.boot_ev = None
        if job.run_ev is not None:
            self.q.cancel(job.run_ev)
            job.run_ev = None
        if job.ckpt_ev is not None:
            self.q.cancel(job.ckpt_ev)
            job.ckpt_ev = None
        if job.state == RUNNING:
            job.remaining_s = job.work_s - job.progress_now(self.now)
            self.running.remove(job.jid)
        self._release(job)

    def _release(self, job: SimJob) -> None:
        for h in job.hosts:
            del self.host_job[h]
            heapq.heappush(self.free, h)
        self.used -= len(job.hosts)
        job.hosts = ()

    def _place(self, job: SimJob, resume: bool) -> None:
        hosts = tuple(heapq.heappop(self.free) for _ in range(job.n_vms))
        for h in hosts:
            self.host_job[h] = job.jid
        self.used += len(hosts)
        job.hosts = hosts
        job.state = BOOTING
        cost = job.boot_s + (job.restore_s if resume else 0.0)
        job.boot_ev = self.q.schedule(self.now + cost, "boot_done", job.jid)

    # ---- scheduling ------------------------------------------------------
    def _schedule_queue(self) -> None:
        # victim preemptions re-enqueue mid-pass; iterate to fixpoint
        while self._schedule_pass():
            pass

    def _schedule_pass(self) -> bool:
        if not self.waiting:
            return False
        run_sorted: Optional[List[int]] = None   # (pri, jid)-ordered, lazy
        low_pri = (min(self.jobs[v].priority for v in self.running)
                   if self.running else _MAX_PRI + 1)
        placed: List[Tuple[float, int]] = []
        for entry in list(self.waiting):         # snapshot: pass may insort
            _, jid = entry
            job = self.jobs[jid]
            if job.state != QUEUED:              # placed earlier this pass
                continue
            self.sched_scans += 1
            if job.n_vms <= len(self.free):
                self._admit(job, entry, placed)
                continue
            # nothing left that could fit outright or preempt?  both
            # checks are O(priorities)/O(vm sizes) over count arrays
            if not any(self.wait_pri_count[p]
                       for p in range(low_pri + 1, _MAX_PRI + 1)):
                if len(self.free) < self._min_wait_vms():
                    break
                continue
            if job.priority <= low_pri:
                continue                         # cannot preempt anyone
            # victims: strictly lower *raw* priority, lowest (pri, jid)
            # first, and only if the sum actually makes the job fit
            if run_sorted is None:
                run_sorted = sorted(
                    self.running,
                    key=lambda v: (self.jobs[v].priority, v))
            victims: List[SimJob] = []
            freed = len(self.free)
            for vjid in run_sorted:
                v = self.jobs[vjid]
                if v.state != RUNNING:           # preempted earlier in pass
                    continue
                if v.priority >= job.priority:
                    break
                victims.append(v)
                freed += len(v.hosts)
                if freed >= job.n_vms:
                    break
            if freed < job.n_vms or not victims:
                continue                         # a smaller job may still fit
            for v in victims:
                # swap-out: progress up to now is checkpointed
                v.saved_s = v.progress_now(self.now)
                self._halt(v)
                v.preemptions += 1
                self.preemptions += 1
                self._enqueue(v)
                self._emit("preempt", f"j{v.jid} by=j{jid}")
            low_pri = (min(self.jobs[v].priority for v in self.running)
                       if self.running else _MAX_PRI + 1)
            self._admit(job, entry, placed)
        if not placed:
            return False
        gone = set(placed)
        self.waiting = [e for e in self.waiting if e not in gone]
        return True

    def _admit(self, job: SimJob, entry: Tuple[float, int],
               placed: List[Tuple[float, int]]) -> None:
        self.wait_pri_count[job.priority] -= 1
        self.wait_vms_count[job.n_vms] -= 1
        resume = job.recoveries > 0 or job.preemptions > 0
        self._place(job, resume)
        placed.append(entry)
        self._emit("place", f"j{job.jid}")

    # ---- invariants ------------------------------------------------------
    def check_invariants(self) -> None:
        """Full O(jobs) capacity-safety cross-check."""
        used = sum(len(j.hosts) for j in self.jobs if j.hosts)
        if used != self.used:
            raise InvariantViolation(
                f"t={self.now}: used counter {self.used} != actual {used}")
        if used + len(self.free) != self.n_hosts:
            raise InvariantViolation(
                f"t={self.now}: {used} used + {len(self.free)} free "
                f"!= {self.n_hosts} hosts")
        if len(set(self.free)) != len(self.free):
            raise InvariantViolation(f"t={self.now}: double-freed host")
        pri_counts = [0] * (_MAX_PRI + 1)
        vms_counts = [0] * (_MAX_VMS + 1)
        for _, jid in self.waiting:
            j = self.jobs[jid]
            if j.state != QUEUED:
                raise InvariantViolation(
                    f"t={self.now}: j{jid} in waiting but not QUEUED")
            pri_counts[j.priority] += 1
            vms_counts[j.n_vms] += 1
        if pri_counts != self.wait_pri_count:
            raise InvariantViolation(
                f"t={self.now}: waiting priority counts drifted")
        if vms_counts != self.wait_vms_count:
            raise InvariantViolation(
                f"t={self.now}: waiting VM-size counts drifted")

    def assert_work_conserving(self) -> None:
        """No schedulable waiter may be left behind at quiescence."""
        for _, jid in self.waiting:
            j = self.jobs[jid]
            if j.n_vms <= len(self.free):
                raise InvariantViolation(
                    f"j{j.jid} waits ({j.n_vms} vms) with "
                    f"{len(self.free)} hosts free")

    # ---- trace -----------------------------------------------------------
    def trace_bytes(self) -> bytes:
        return "\n".join(self.trace).encode()

    def trace_digest(self) -> str:
        return hashlib.sha256(self.trace_bytes()).hexdigest()
