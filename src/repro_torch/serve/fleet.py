"""Checkpoint-backed serving fleet: the paper's job-swapping story at
user scale (ROADMAP "Checkpoint-backed serving fleet").

A :class:`FleetController` manages N ServeApp replicas of one model as
ordinary GlobalScheduler jobs:

* **scale OUT** — a new replica is submitted with
  ``GlobalScheduler.submit(adopt_prefix=<seed>)``: its cold start
  *restores the shared seed image straight from CAS* (prefix adoption —
  zero chunk re-uploads, the replica's own prefix stays empty), and the
  wall/virtual time from submit to RUNNING is recorded as the replica's
  **cold-start latency** — a registry histogram plus a per-job gauge
  under the job's trace_id (``coord.<trace_id>.coldstart_s``) and a
  ``fleet/coldstart`` trace event. Replicas parked by an earlier
  scale-in are preferred over fresh submits (their suspend image resumes
  warmer than the seed).
* **scale IN** — idle replicas are *suspended* through the standard
  swap-out path (their mid-generation state goes to stable storage) and
  flagged ``fleet_parked`` so the scheduler's queue pass hands their
  hosts to batch work instead of auto-resuming them.
* **routing** — a deterministic least-outstanding :class:`Router`
  (serve/workload.py) spreads requests over live replicas.

The controller is deliberately *driven* (``autoscale_step()``), not a
daemon: the benchmark and tests pace it explicitly on the installed
clock, so seeded scenarios replay exactly.

Port of ``repro/serve/fleet.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.ckpt.writer import save_checkpoint
from repro_torch.core.coordinator import ASR, CheckpointPolicy, CoordState
from repro_torch.obs.telemetry import registry, unique_name
from repro_torch.obs.trace import tracer
from repro_torch.serve.workload import FleetPolicy, Router
from repro_torch.sim.simtime import active_clock


class FleetController:
    """Suspend/restore autoscaler for one model's serving replicas."""

    def __init__(self, service, scheduler, *, name: str,
                 replica_factory: Callable[[], Any],
                 seed_prefix: Optional[str] = None,
                 policy: FleetPolicy = FleetPolicy(),
                 backend: str = "", store: str = "default",
                 priority: int = 5, clouds: tuple = (),
                 swap_codec: Optional[str] = None):
        self.service = service
        self.scheduler = scheduler
        self.name = name
        self.replica_factory = replica_factory
        self.seed_prefix = seed_prefix or f"fleet/{name}/seed"
        self.policy = policy
        self.backend = backend or next(iter(service.cloud.backends()))
        self.store_name = store
        self.priority = priority
        self.clouds = clouds
        self.swap_codec = swap_codec
        self.router = Router()
        self._replicas: List[str] = []           # every coord_id, in order
        self._pending: Dict[str, float] = {}     # coord_id -> scale-out t0
        self._fresh: set = set()                 # pending first-time starts
        self._last_busy: Dict[str, float] = {}   # coord_id -> last activity
        self._next_idx = 0
        self._last_scale = float("-inf")
        self._cold_hist = registry().histogram(
            unique_name(f"fleet.{name}.coldstart_s"))
        self.coldstarts = 0
        self.coldstart_reuploads = 0             # must stay 0 (adoption)
        self.parks = 0
        self.unparks = 0

    # ------------------------------------------------------------------
    # seed lineage
    # ------------------------------------------------------------------
    def publish_seed(self, state: Any, *, step: int = 1,
                     codec: str = "raw") -> None:
        """Commit the shared warm image every replica adopts on cold
        start (e.g. a prefilled ServeApp's checkpoint_state). One CAS
        upload serves the whole fleet for its lifetime."""
        save_checkpoint(self.service.ckpt.store(self.store_name),
                        self.seed_prefix, step, state, codec=codec,
                        metadata={"fleet": self.name, "seed": True})

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def replicas(self) -> List[str]:
        return list(self._replicas)

    def live(self) -> List[str]:
        out = []
        for cid in self._replicas:
            try:
                if self.service.db.get(cid).state == CoordState.RUNNING:
                    out.append(cid)
            except KeyError:
                pass
        return out

    def parked(self) -> List[str]:
        out = []
        for cid in self._replicas:
            try:
                coord = self.service.db.get(cid)
            except KeyError:
                continue
            if (coord.state == CoordState.SUSPENDED
                    and coord.metrics.get("fleet_parked")):
                out.append(cid)
        return out

    def _asr(self) -> ASR:
        idx = self._next_idx
        self._next_idx += 1
        return ASR(name=f"{self.name}-r{idx:03d}", n_vms=1,
                   backend=self.backend,
                   app_factory=self.replica_factory,
                   policy=CheckpointPolicy(period_s=0.0,
                                           store=self.store_name,
                                           swap_codec=self.swap_codec),
                   priority=self.priority, clouds=self.clouds)

    # ------------------------------------------------------------------
    # scale out (unpark first, else adopt the seed lineage)
    # ------------------------------------------------------------------
    def scale_out(self, n: int = 1) -> List[str]:
        started: List[str] = []
        for _ in range(n):
            if len(self._replicas) - len(self.parked()) \
                    >= self.policy.max_replicas and not self.parked():
                break
            t0 = active_clock().now()
            parked = self.parked()
            if parked:
                cid = parked[0]
                coord = self.service.db.get(cid)
                coord.metrics["fleet_parked"] = 0
                coord.metrics["queued_at_v"] = t0
                self.service.db.persist(coord)
                self.unparks += 1
                self.scheduler.nudge("fleet_unpark")
            else:
                cid = self.scheduler.submit(
                    self._asr(), adopt_prefix=self.seed_prefix)
                self._replicas.append(cid)
                self._fresh.add(cid)
            self._pending[cid] = t0
            started.append(cid)
        return started

    def wait_live(self, coord_ids: Optional[List[str]] = None,
                  timeout: float = 60.0) -> None:
        """Block until the given (default: all pending) replicas are
        RUNNING, then close out their cold-start measurements."""
        for cid in list(coord_ids or self._pending):
            self.service.wait_for_state(cid, CoordState.RUNNING, timeout)
            self.note_running(cid)

    def note_running(self, coord_id: str) -> None:
        """Finalize one replica's cold start: latency into the registry
        histogram AND the job's trace_id-scoped gauge, plus the
        zero-re-upload audit (object count under the replica's own
        prefix — adoption means the restore wrote nothing)."""
        t0 = self._pending.pop(coord_id, None)
        if t0 is None:
            return
        coord = self.service.db.get(coord_id)
        now = active_clock().now()
        cold = max(0.0, now - t0)
        coord.metrics["coldstart_s"] = cold      # -> coord.<trace_id> gauge
        self._cold_hist.observe(cold)
        # zero-re-upload audit, first-time starts only: an adopted cold
        # start writes nothing under its own prefix (an *unparked* replica
        # legitimately owns its suspend image — not a re-upload)
        own_objects = 0
        if coord_id in self._fresh:
            self._fresh.discard(coord_id)
            store = self.service.ckpt.store(self.store_name)
            own_objects = len(store.list(coord.ckpt_prefix + "/"))
            self.coldstart_reuploads += own_objects
        self.coldstarts += 1
        tracer().event("fleet/coldstart", cat="serve",
                       trace_id=coord.trace_id,
                       args={"fleet": self.name, "coldstart_s": cold,
                             "own_objects": own_objects})
        self.router.add(coord_id)
        self._last_busy[coord_id] = now

    # ------------------------------------------------------------------
    # scale in (suspend + park)
    # ------------------------------------------------------------------
    def _idle_for(self, coord_id: str, now: float) -> float:
        if self.router.outstanding(coord_id) > 0:
            return 0.0
        return now - self._last_busy.get(coord_id, now)

    def scale_in(self, n: int = 1, *, force: bool = False) -> List[str]:
        """Park up to ``n`` idle replicas (never below min_replicas).
        ``force`` skips the idle-age check (tests / drain)."""
        now = active_clock().now()
        live = self.live()
        idle = sorted((cid for cid in live
                       if force or self._idle_for(cid, now)
                       >= self.policy.scale_in_idle_s),
                      key=lambda c: -self._idle_for(c, now))
        out: List[str] = []
        for cid in idle:
            if len(live) - len(out) <= self.policy.min_replicas:
                break
            if len(out) >= n:
                break
            coord = self.service.db.get(cid)
            self.router.remove(cid)
            # flag BEFORE the suspend commits: the instant SUSPENDED is
            # visible the scheduler's next pass would otherwise resume it
            coord.metrics["fleet_parked"] = 1
            try:
                self.service.apps.suspend(cid, reason="fleet_scale_in")
            except Exception:              # noqa: BLE001
                coord.metrics["fleet_parked"] = 0
                self.router.add(cid)       # lost a race; still serving
                continue
            self.parks += 1
            registry().inc(f"fleet.{self.name}.parks")
            out.append(cid)
        return out

    # ------------------------------------------------------------------
    # routing + autoscaling
    # ------------------------------------------------------------------
    def route(self) -> Optional[str]:
        rid = self.router.route()
        if rid is not None:
            self._last_busy[rid] = active_clock().now()
        return rid

    def complete(self, replica_id: str) -> None:
        self.router.complete(replica_id)
        self._last_busy[replica_id] = active_clock().now()

    def autoscale_step(self) -> int:
        """One evaluation: scale out when outstanding load per live
        replica exceeds ``target_inflight``, scale in when replicas sit
        idle past ``scale_in_idle_s``. Returns +n/-n replicas changed."""
        now = active_clock().now()
        if now - self._last_scale < self.policy.cooldown_s:
            return 0
        live = self.live()
        n_live = max(1, len(live))
        per = self.router.outstanding() / n_live
        if (per > self.policy.target_inflight
                and len(live) < self.policy.max_replicas):
            changed = len(self.scale_out(1))
            if changed:
                self._last_scale = now
            return changed
        idle = [cid for cid in live
                if self._idle_for(cid, now) >= self.policy.scale_in_idle_s]
        if idle and len(live) > self.policy.min_replicas:
            changed = len(self.scale_in(1))
            if changed:
                self._last_scale = now
            return -changed
        return 0

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": len(self._replicas),
            "live": len(self.live()),
            "parked": len(self.parked()),
            "coldstarts": self.coldstarts,
            "coldstart_reuploads": self.coldstart_reuploads,
            "parks": self.parks,
            "unparks": self.unparks,
            "routed": self.router.routed,
        }
