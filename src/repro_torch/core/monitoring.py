"""Monitoring Manager (paper §6.3): liveness + application health.

Two mechanisms, mirroring the paper exactly:
  * native failure notifications, where the backend supports them (Snooze) —
    zero polling, immediate recovery;
  * a cloud-agnostic **binary broadcast tree** of per-VM monitoring daemons
    for backends without notifications (OpenStack): the root probes down the
    tree and aggregates health reports up — one round trip costs
    O(log2 n) hops (reproduced in Fig 4c's benchmark).

Health ≠ liveness: each application provides a health hook; the monitor also
derives *performance* health (straggler detection via per-step-time
z-scores) — the paper's "exceptionally low performance ... proactively
suspends the job" feature (§1, use case 3 of §2.2).

Consumers: `core/app_manager.py` subscribes and maps reports onto the
paper's two recovery paths — VM failure → replace + restore from latest
image (§6.3 case 1); application failure → in-place restart (§6.3 case 2).
The broadcast-tree round-trip cost is measured in
`benchmarks/fig4_service_load.py` (Fig 4c).

Port of ``repro/core/monitoring.py``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.clusters.base import VMHandle
from repro_torch.obs.telemetry import paper_now, registry
from repro_torch.obs.trace import tracer
from repro_torch.sim.simtime import active_clock
from repro_torch.clusters.simulator import sim_sleep


@dataclasses.dataclass
class HealthReport:
    unreachable: List[str]           # vm ids
    unhealthy: List[str]             # vm ids failing the app health hook
    stragglers: List[str]            # vm ids with degraded performance
    rtt_s: float                     # broadcast-tree round-trip (simulated)

    @property
    def ok(self) -> bool:
        return not (self.unreachable or self.unhealthy)


def tree_depth(n: int) -> int:
    return max(1, math.ceil(math.log2(n + 1)))


def heartbeat_roundtrip(vms: Sequence[VMHandle],
                        health_hook: Optional[Callable[[], bool]] = None,
                        hop_latency_s: float = 0.05,
                        straggler_threshold: float = 3.0) -> HealthReport:
    """One probe/aggregate round over the binary broadcast tree.

    The tree is rooted at vms[0]; node i's children are 2i+1 / 2i+2. The
    probe descends and reports ascend level-by-level, so the critical path
    is 2 * depth hops — each VM is visited once (the paper's evidence that
    the tree "consumes few network resources and scales").
    """
    n = len(vms)
    depth = tree_depth(n)
    sim_sleep(2 * depth * hop_latency_s)          # critical path
    unreachable = [vm.vm_id for vm in vms if not vm.reachable]
    reachable = [vm for vm in vms if vm.reachable]
    unhealthy: List[str] = []
    # Only ask the app when it can answer: with every VM unreachable there
    # is no daemon to run the hook, and a raising hook is an *unhealthy
    # application*, not a dead monitor thread (the old behaviour let a
    # broken user hook kill the polling loop).
    if health_hook is not None and reachable:
        try:
            healthy = bool(health_hook())
        except Exception:                          # noqa: BLE001
            healthy = False
        if not healthy:
            # the hook is application-scoped; attribute it to the root daemon
            unhealthy.append(vms[0].vm_id)
    # performance health: hosts running significantly slower than the
    # fleet's typical pace (median-relative — uniform slowness is the
    # workload, an outlier is a straggler). With <2 reachable hosts (or a
    # degenerate zero median) there is no pace baseline: report none.
    slowdowns = sorted(vm.host.slowdown for vm in reachable)
    stragglers = []
    if len(slowdowns) >= 2:
        median = slowdowns[len(slowdowns) // 2]
        if median > 0:
            for vm in reachable:
                if vm.host.slowdown > straggler_threshold * median:
                    stragglers.append(vm.vm_id)
    return HealthReport(unreachable, unhealthy, stragglers,
                        rtt_s=2 * depth * hop_latency_s)


@dataclasses.dataclass
class LowPerfConfig:
    """Baseline-relative low-performance detection (paper §1: jobs that
    "incur exceptionally low performance" are proactively suspended).

    Each watched app publishes a throughput sample per poll (its
    ``perf_fn`` progress counter differenced over the poll window, in
    units/paper-second) into the metrics registry, smoothed by an EWMA.
    The first ``warmup_samples`` samples establish a baseline (the peak
    observed rate — it also ratchets up later, so jit warmup cannot lock
    in a slow baseline); once the EWMA stays below
    ``degradation_factor * baseline`` for ``grace_polls`` consecutive
    samples the monitor reports ``low_performance`` exactly once per
    watch. ``min_window_s`` (paper seconds) is the smallest poll window a
    rate is computed over (shorter windows are folded into the next one).
    """
    degradation_factor: float = 0.4
    grace_polls: int = 3
    warmup_samples: int = 3
    ewma_alpha: float = 0.3
    min_window_s: float = 0.5


class MonitoringManager:
    """Watches RUNNING applications; triggers recovery callbacks.

    ``recover_cb(coord_id, kind)`` with kind in {"vm_failure",
    "app_failure", "straggler", "low_performance"} — the Application
    Manager decides the recovery action (paper §6.3's two cases +
    proactive suspend).
    """

    def __init__(self, recover_cb: Callable[[str, str], None],
                 poll_interval_s: float = 0.05,
                 native_grace_polls: int = 3,
                 straggler_threshold: float = 3.0,
                 lowperf: Optional[LowPerfConfig] = None):
        self._recover_cb = recover_cb
        self.poll_interval_s = poll_interval_s
        # Native backends notify VM *crashes*, but a network partition is
        # invisible to the IaaS — after this many consecutive unreachable
        # polls the tree declares the VM failed anyway (paper §6.3's
        # cloud-agnostic path backstopping the notification path).
        self.native_grace_polls = native_grace_polls
        # z-score cutoff for the broadcast tree's host-pace straggler
        # check; float("inf") disables it (e.g. to exercise the
        # telemetry-driven detector alone)
        self.straggler_threshold = straggler_threshold
        # telemetry-driven throughput watchdog; None = disabled (chaos
        # scenarios and CACSService(lowperf=...) turn it on)
        self.lowperf = lowperf
        self.lowperf_detections = 0
        self._watched: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.heartbeats = 0
        self.native_notifications = 0
        self.partition_fallbacks = 0
        # whole-fleet outage telemetry: polls where EVERY VM of an app was
        # unreachable at once. A single VM failing is the paper's §6.3
        # case 1; the entire fleet going dark at once is the cloud-outage
        # signature that cross-cloud failover (core/replication.py) keys on.
        self.fleet_unreachable_polls = 0
        self._fleet_down: set = set()

    # ---- registration --------------------------------------------------
    def watch(self, coord_id: str, vms: Sequence[VMHandle],
              health_hook: Optional[Callable[[], bool]],
              native_notifications: bool,
              perf_fn: Optional[Callable[[], float]] = None,
              trace_id: str = "") -> None:
        """``perf_fn`` is a monotonic progress counter (steps, tokens,
        iterations); the monitor differences it per poll into a
        throughput gauge and feeds the low-performance detector.  A
        re-watch (resume, restart) resets the perf baseline — the new
        placement earns its own warmup."""
        anchor = None
        if perf_fn is not None:
            try:
                anchor = (paper_now(), float(perf_fn()))
            except Exception:                      # noqa: BLE001
                anchor = None                      # app not started yet
        with self._lock:
            self._watched[coord_id] = {
                "vms": list(vms), "hook": health_hook,
                "native": native_notifications, "unreachable_polls": 0,
                "perf_fn": perf_fn, "trace_id": trace_id,
                "perf_anchor": anchor, "perf_ewma": None,
                "perf_peak": 0.0, "perf_warmup": 0,
                "perf_baseline": None, "perf_below": 0, "perf_fired": False,
            }
            self._fleet_down.discard(coord_id)

    def unwatch(self, coord_id: str) -> None:
        with self._lock:
            self._watched.pop(coord_id, None)

    def on_native_failure(self, coord_id: str) -> None:
        """Entry point for backend failure notifications (Snooze path)."""
        self.native_notifications += 1
        self._recover_cb(coord_id, "vm_failure")

    # ---- polling loop (agent-based path) ---------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        # poll pacing through the installed clock (read live so a virtual
        # clock installed for the test session is honored): under SimClock
        # the interval elapses in virtual time instead of wall sleeping
        while not active_clock().wait(self._stop, self.poll_interval_s):
            with self._lock:
                watched = dict(self._watched)
            for coord_id, info in watched.items():
                try:
                    self._poll_one(coord_id, info)
                except Exception:                  # noqa: BLE001
                    # one bad probe must not kill the monitor for everyone
                    continue

    def _poll_one(self, coord_id: str, info: dict) -> None:
        report = self.check_once(coord_id)
        if report is None:
            return
        registry().inc("monitor.polls")
        if not report.ok or report.stragglers:
            # a healthy poll is only counted: one event per job per tick
            # would crowd the other spans out of the tracer's records
            tracer().event("monitor/poll", cat="monitor",
                           trace_id=info.get("trace_id", ""),
                           args={"coord": coord_id, "ok": report.ok,
                                 "stragglers": len(report.stragglers)})
        if report.unreachable:
            if len(report.unreachable) == len(info["vms"]):
                # the whole fleet is dark at once — record the outage
                # signature (sticky until the next successful watch) for
                # the failover controller to corroborate against
                with self._lock:
                    self.fleet_unreachable_polls += 1
                    self._fleet_down.add(coord_id)
            if not info["native"]:
                self._recover_cb(coord_id, "vm_failure")
            elif self._bump_unreachable(coord_id) >= self.native_grace_polls:
                # partition fallback: the IaaS never reported a crash, yet
                # the tree cannot reach the VM — declare it failed. Reset
                # the streak so one partition counts once (the recovery's
                # unwatch lands asynchronously; later ticks must restart
                # the grace window, not re-count the same fault).
                self._reset_unreachable(coord_id)
                self.partition_fallbacks += 1
                self._recover_cb(coord_id, "vm_failure")
            return
        self._reset_unreachable(coord_id)
        with self._lock:
            self._fleet_down.discard(coord_id)
        if report.unhealthy:
            self._recover_cb(coord_id, "app_failure")
        elif report.stragglers:
            self._recover_cb(coord_id, "straggler")
        elif self._check_perf(coord_id, info):
            self.lowperf_detections += 1
            registry().inc("monitor.lowperf_detections")
            tracer().event("monitor/low_performance", cat="monitor",
                           trace_id=info.get("trace_id", ""),
                           args={"coord": coord_id,
                                 "ewma": info.get("perf_ewma"),
                                 "baseline": info.get("perf_baseline")})
            self._recover_cb(coord_id, "low_performance")

    def _check_perf(self, coord_id: str, info: dict) -> bool:
        """One throughput sample for the low-performance detector; True
        exactly once per watch when degradation is confirmed."""
        cfg = self.lowperf
        fn = info.get("perf_fn")
        if cfg is None or fn is None or info.get("perf_fired"):
            return False
        try:
            count = float(fn())
        except Exception:                          # noqa: BLE001
            return False
        now = paper_now()
        anchor = info.get("perf_anchor")
        if anchor is None:
            info["perf_anchor"] = (now, count)
            return False
        t0, c0 = anchor
        if now - t0 < cfg.min_window_s:
            return False                           # fold into the next poll
        rate = max(0.0, count - c0) / (now - t0)
        info["perf_anchor"] = (now, count)
        ewma = info.get("perf_ewma")
        ewma = rate if ewma is None else (
            cfg.ewma_alpha * rate + (1.0 - cfg.ewma_alpha) * ewma)
        info["perf_ewma"] = ewma
        reg = registry()
        reg.set_gauge(f"app.throughput:{coord_id}", rate)
        reg.set_gauge(f"app.throughput_ewma:{coord_id}", ewma)
        baseline = info.get("perf_baseline")
        if baseline is None:
            # warmup: the peak observed rate becomes the baseline (a mean
            # would be polluted by a fault landing mid-warmup)
            info["perf_peak"] = max(info["perf_peak"], rate)
            info["perf_warmup"] += 1
            if info["perf_warmup"] >= cfg.warmup_samples \
                    and info["perf_peak"] > 0:
                info["perf_baseline"] = info["perf_peak"]
            return False
        if ewma > baseline:                        # jit warmup can raise the
            info["perf_baseline"] = baseline = ewma    # pace post-warmup
        if ewma < cfg.degradation_factor * baseline:
            info["perf_below"] += 1
        else:
            info["perf_below"] = 0
        if info["perf_below"] >= cfg.grace_polls:
            info["perf_fired"] = True              # once per watch
            return True
        return False

    def _bump_unreachable(self, coord_id: str) -> int:
        with self._lock:
            info = self._watched.get(coord_id)
            if info is None:
                return 0
            info["unreachable_polls"] += 1
            return info["unreachable_polls"]

    def _reset_unreachable(self, coord_id: str) -> None:
        with self._lock:
            info = self._watched.get(coord_id)
            if info is not None:
                info["unreachable_polls"] = 0

    def fleet_unreachable(self, coord_id: str) -> bool:
        """True while the last probes saw *every* VM of this app dark (the
        flag is sticky across unwatch so a post-recovery-failure failover
        decision can still read it; re-watching clears it)."""
        with self._lock:
            return coord_id in self._fleet_down

    def check_once(self, coord_id: str) -> Optional[HealthReport]:
        with self._lock:
            info = self._watched.get(coord_id)
        if info is None:
            return None
        self.heartbeats += 1
        return heartbeat_roundtrip(
            info["vms"], info["hook"],
            straggler_threshold=self.straggler_threshold)
