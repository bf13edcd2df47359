"""Request-storm serving fleet on the discrete-event engine.

Extends :class:`~repro_torch.sim.engine.SimEngine` with an always-on serving
tier driven by a seeded :class:`~repro_torch.serve.workload.RequestTrace`
(diurnal + bursty, millions of requests): the *control plane* — replica
boots, suspends (scale-in parks), autoscaler ticks, batch-job arrivals,
host faults — runs as discrete events on the shared queue, while the
*data plane* (per-request routing and latency) is handled arithmetically
between events against per-replica service slots. Requests are never
individual events, so a simulated day of 7-digit request counts costs
seconds of wall time, and the control trace stays byte-identical for a
seed.

Replicas are ordinary :class:`SimJob`s at the top priority
(``_MAX_PRI``): scaling out *preempts* batch work when the cluster is
full (the GlobalScheduler's swap-out applied in reverse), and scaling in
parks a replica — its hosts go back to the free pool for batch jobs,
mirroring ``serve/fleet.py``'s suspend + ``fleet_parked`` path. A cold
start pays ``replica_boot_s`` (VM boot + CAS seed restore via prefix
adoption); a park pays ``suspend_s`` of swap-out before the hosts free.

Mirrors of the real stack, checked by the same benchmark
(`benchmarks/serve_fleet.py`): p99 request latency and
served-QPS-per-replica-host-second for a policy-scaled fleet vs a static
one under the same over-subscribed cloud and the same request bytes.

Port of ``repro/sim/serve.py``.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional

from repro_torch.serve.workload import FleetPolicy, RequestTrace
from repro_torch.sim.engine import (_MAX_PRI, BOOTING, QUEUED, RUNNING,
                                    InvariantViolation, SimEngine, SimJob)

#: extra SimJob state for a scale-in'd replica (engine states are 0..3)
PARKED = 4

#: replica work_s sentinel — far past any horizon, so run_done never fires
_FOREVER_S = 1e15


class ServeFleetEngine(SimEngine):
    """SimEngine + serving replicas + arithmetic request data plane."""

    def __init__(self, n_hosts: int, seed: int, *, trace: RequestTrace,
                 policy: FleetPolicy, service_s: float = 0.05,
                 concurrency: int = 4, hosts_per_replica: int = 1,
                 replica_boot_s: float = 20.0, suspend_s: float = 5.0,
                 **kw):
        super().__init__(n_hosts, seed, **kw)
        self.req_trace = trace
        self.policy = policy
        self.service_s = service_s
        self.concurrency = concurrency          # batch slots per replica
        self.hosts_per_replica = hosts_per_replica
        self.replica_boot_s = replica_boot_s
        self.suspend_s = suspend_s
        self._arrivals = iter(trace)
        self._next_arrival: Optional[float] = next(self._arrivals, None)
        self.replica_jids: set = set()
        self.live: List[int] = []               # routing membership, sorted
        self._slots: Dict[int, List[float]] = {}   # jid -> free_at min-heap
        self._busy_until: Dict[int, float] = {}
        self._parking: set = set()              # jids mid-swap-out
        self.parked_jids: List[int] = []
        self.pending: List[float] = []          # arrivals with no live fleet
        self.latencies: List[float] = []
        self.requests = 0
        self.served = 0
        self.coldstarts = 0
        self.parks = 0
        self.unparks = 0
        self.replica_host_s = 0.0
        self._hold_start: Dict[int, float] = {}
        self._window_arrivals = 0
        if policy.eval_period_s > 0:
            self.q.schedule(policy.eval_period_s, "autoscale", None)

    # ------------------------------------------------------------------
    # fleet control
    # ------------------------------------------------------------------
    def start_fleet(self, n: int) -> None:
        """Bring up the initial replicas at t=0 (before run())."""
        for _ in range(n):
            self._new_replica()

    def _new_replica(self) -> int:
        job = SimJob(jid=len(self.jobs), arrival_s=self.now,
                     n_vms=self.hosts_per_replica, priority=_MAX_PRI,
                     work_s=_FOREVER_S, ckpt_period_s=0.0,
                     boot_s=self.replica_boot_s, restore_s=0.0)
        job.remaining_s = job.work_s
        self.jobs.append(job)
        self.replica_jids.add(job.jid)
        self.coldstarts += 1
        self._emit("scale_out", f"j{job.jid} cold")
        self._enqueue(job)
        self._schedule_queue()
        return job.jid

    def _active_replicas(self) -> int:
        """Replicas serving or on their way up (not parked/parking)."""
        return sum(1 for jid in self.replica_jids
                   if self.jobs[jid].state in (QUEUED, BOOTING, RUNNING)
                   and jid not in self._parking)

    def _scale_out(self) -> None:
        if self.parked_jids:
            jid = self.parked_jids.pop(0)
            job = self.jobs[jid]
            job.state = QUEUED
            self.unparks += 1
            self._emit("scale_out", f"j{jid} unpark")
            self._enqueue(job)
            self._schedule_queue()
        else:
            self._new_replica()

    def _scale_in(self, jid: int) -> None:
        """Stop routing to an idle replica and start its swap-out; the
        hosts free (for batch work) when the suspend write completes."""
        self.live.remove(jid)
        del self._slots[jid]
        self._parking.add(jid)
        self.parks += 1
        self._emit("scale_in", f"j{jid}")
        self.q.schedule(self.now + self.suspend_s, "park_done", jid)

    def _on_park_done(self, ev) -> None:
        jid = ev.payload
        self._parking.discard(jid)
        job = self.jobs[jid]
        if job.state != RUNNING:                # faulted mid-swap-out
            return
        self._halt(job)
        job.state = PARKED
        self.parked_jids.append(jid)
        self._emit("parked", f"j{jid}")
        self._schedule_queue()                  # batch takes the hosts

    def _on_autoscale(self, ev) -> None:
        p = self.policy
        qps = self._window_arrivals / max(p.eval_period_s, 1e-9)
        self._window_arrivals = 0
        cap = (self.concurrency / self.service_s) * p.target_util
        desired = max(p.min_replicas,
                      min(p.max_replicas, math.ceil(qps / max(cap, 1e-9))))
        active = self._active_replicas()
        if desired > active:
            for _ in range(desired - active):
                self._scale_out()
        elif desired < active:
            # only genuinely idle replicas park, oldest-id first
            idle = [jid for jid in self.live
                    if self._busy_until.get(jid, 0.0)
                    <= self.now - p.scale_in_idle_s]
            for jid in idle[:active - desired]:
                if self._active_replicas() <= p.min_replicas:
                    break
                self._scale_in(jid)
        self.q.schedule(self.now + p.eval_period_s, "autoscale", None)

    # ------------------------------------------------------------------
    # engine-event overrides (replica bookkeeping rides the host paths)
    # ------------------------------------------------------------------
    def _place(self, job: SimJob, resume: bool) -> None:
        super()._place(job, resume)
        if job.jid in self.replica_jids:
            self._hold_start[job.jid] = self.now

    def _release(self, job: SimJob) -> None:
        if job.jid in self.replica_jids and job.hosts:
            t0 = self._hold_start.pop(job.jid, self.now)
            self.replica_host_s += (self.now - t0) * len(job.hosts)
        super()._release(job)

    def _halt(self, job: SimJob) -> None:
        # a host fault can kill a LIVE replica: drop it from routing
        if job.jid in self.replica_jids:
            if job.jid in self.live:
                self.live.remove(job.jid)
                self._slots.pop(job.jid, None)
        super()._halt(job)

    def _on_fault(self, ev) -> None:
        jid = self.host_job.get(ev.payload)
        super()._on_fault(ev)                   # halts + re-enqueues the job
        if jid is not None and jid in self.replica_jids:
            self._emit("replica_fault", f"j{jid}")

    def _on_boot_done(self, ev) -> None:
        job = self.jobs[ev.payload]
        was_booting = job.state == BOOTING
        super()._on_boot_done(ev)
        if (was_booting and job.state == RUNNING
                and job.jid in self.replica_jids):
            self.live.append(job.jid)
            self.live.sort()
            self._slots[job.jid] = [self.now] * self.concurrency
            self._busy_until[job.jid] = self.now
            self._emit("replica_up", f"j{job.jid}")
            if self.pending:
                backlog, self.pending = self.pending, []
                for t in backlog:
                    self._serve(t)

    # ------------------------------------------------------------------
    # data plane: arithmetic request handling between events
    # ------------------------------------------------------------------
    def _serve(self, t: float) -> None:
        """Route one arrival to the live replica that can start it
        soonest (least-outstanding; lowest jid tie-break — the Router
        discipline, expressed over slot availability)."""
        best_jid = -1
        best_start = 0.0
        for jid in self.live:                   # sorted: ties -> lowest jid
            free = self._slots[jid][0]
            start = free if free > t else t
            if best_jid < 0 or start < best_start:
                best_jid, best_start = jid, start
        if best_jid < 0:
            self.pending.append(t)
            return
        done = best_start + self.service_s
        heapq.heapreplace(self._slots[best_jid], done)
        if done > self._busy_until.get(best_jid, 0.0):
            self._busy_until[best_jid] = done
        self.latencies.append(done - t)
        self.served += 1

    def _consume_arrivals(self, t_limit: float) -> None:
        nxt = self._next_arrival
        while nxt is not None and nxt <= t_limit:
            self.requests += 1
            self._window_arrivals += 1
            self._serve(nxt)
            nxt = next(self._arrivals, None)
        self._next_arrival = nxt

    def run(self, until: Optional[float] = None) -> None:
        end = self.req_trace.horizon_s if until is None else until
        while True:
            ev = self.q.pop()
            if ev is None or ev.time > end:
                break
            self._consume_arrivals(ev.time)
            self.now = ev.time
            self.events_fired += 1
            getattr(self, f"_on_{ev.kind}")(ev)
            if self.used + len(self.free) != self.n_hosts:
                raise InvariantViolation(
                    f"t={self.now}: {self.used} used + {len(self.free)} "
                    f"free != {self.n_hosts} hosts")
            if self.events_fired % self.DEEP_CHECK_EVERY == 0:
                self.check_invariants()
        self._consume_arrivals(end)
        self.now = max(self.now, end)
        self._settle_holds()
        self.check_invariants()

    def _settle_holds(self) -> None:
        """Account host time still held by live/booting replicas up to
        now (idempotent: the hold window restarts at now)."""
        for jid, t0 in list(self._hold_start.items()):
            hosts = len(self.jobs[jid].hosts)
            self.replica_host_s += (self.now - t0) * hosts
            self._hold_start[jid] = self.now

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        super().check_invariants()
        for jid in self.live:
            if self.jobs[jid].state != RUNNING:
                raise InvariantViolation(
                    f"t={self.now}: live replica j{jid} not RUNNING")
        for jid in self.parked_jids:
            if self.jobs[jid].state != PARKED:
                raise InvariantViolation(
                    f"t={self.now}: parked replica j{jid} not PARKED")

    def latency_percentile(self, p: float) -> float:
        if not self.latencies:
            return 0.0
        lat = sorted(self.latencies)
        idx = min(len(lat) - 1, int(p / 100.0 * len(lat)))
        return lat[idx]

    def fleet_stats(self) -> Dict[str, float]:
        batch_done = self.completed
        return {
            "requests": float(self.requests),
            "served": float(self.served),
            "p50_s": self.latency_percentile(50.0),
            "p99_s": self.latency_percentile(99.0),
            "replica_host_s": self.replica_host_s,
            "served_qps_per_host": (self.served / self.replica_host_s
                                    if self.replica_host_s > 0 else 0.0),
            "coldstarts": float(self.coldstarts),
            "parks": float(self.parks),
            "unparks": float(self.unparks),
            "batch_completed": float(batch_done),
        }
