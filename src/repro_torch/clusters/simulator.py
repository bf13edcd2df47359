"""Virtual cluster simulator: hosts, failures, and a calibrated cost model.

The simulator stands in for the IaaS data plane (Grid'5000 in the paper).
Costs are paper-calibrated seconds paid through the installed Clock
(repro_torch.sim): under the default WallClock they are wall sleeps scaled by
``TIME_SCALE`` so the paper's curves (Fig 3/4/6) reproduce shape-faithfully
in seconds instead of minutes; under a SimClock they advance virtual time
instantly.  Failure injection drives the fault-tolerance integration tests.

Port of ``repro/clusters/simulator.py``.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import uuid
from typing import Callable, Dict, List, Optional

# Canonical definition lives in repro_torch.sim.simtime; re-exported here for
# backward compatibility (chaos/benchmarks import it from this module).
from repro_torch.sim.simtime import TIME_SCALE, active_clock


def sim_sleep(seconds: float) -> None:
    """Pay a paper-calibrated cost through the installed clock."""
    if seconds > 0:
        active_clock().paper_sleep(seconds)


class HostState(enum.Enum):
    IDLE = "idle"
    ALLOCATED = "allocated"
    FAILED = "failed"


@dataclasses.dataclass
class VirtualHost:
    host_id: str
    vcpus: int = 2
    memory_gb: int = 4
    state: HostState = HostState.IDLE
    owner: Optional[str] = None        # coordinator id
    # health-degradation knob for straggler tests: multiplier on step time
    slowdown: float = 1.0
    # network-partition knob: the host is alive and ALLOCATED but cannot be
    # reached by the monitoring tree (distinct from a crash — the IaaS does
    # NOT report partitions, so native notifications never fire for them)
    partitioned: bool = False


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibrated against the paper's measurements (see benchmarks/)."""
    alloc_base_s: float = 5.0          # IaaS request processing
    alloc_per_vm_s: float = 1.0        # per-VM boot cost
    alloc_batch_parallel: int = 8      # VMs booted concurrently by the IaaS
    ssh_cmd_s: float = 0.5             # one provisioning command on one VM
    ssh_connect_s: float = 1.0         # new SSH connection setup
    hop_latency_s: float = 0.05        # one monitoring-tree hop
    release_s: float = 0.5


class ClusterSim:
    """A pool of virtual hosts + failure injection."""

    def __init__(self, n_hosts: int, cost: CostModel = CostModel(),
                 name: str = "cluster"):
        self.name = name
        self.cost = cost
        self._hosts: Dict[str, VirtualHost] = {}
        self._lock = threading.RLock()
        self._failure_listeners: List[Callable[[VirtualHost], None]] = []
        self._fault_listeners: List[Callable[[str, str, float], None]] = []
        self._capacity_listeners: List[Callable[[], None]] = []
        self._allocation_listeners: List[Callable[[str, int], None]] = []
        # whole-cloud outage flag: every host partitioned AND allocation
        # denied until heal_outage() (the paper's cross-cloud failover
        # motivation — losing one entire cloud backend)
        self.in_outage = False
        # per-VM message channels (gang checkpointing): host_id -> the
        # in-flight messages addressed to it (sent, not yet received)
        self._channels: Dict[str, List] = {}
        self.messages_sent = 0
        self.messages_received = 0
        for i in range(n_hosts):
            hid = f"{name}-host-{i:04d}"
            self._hosts[hid] = VirtualHost(host_id=hid)

    # ---- capacity ------------------------------------------------------
    @property
    def n_hosts(self) -> int:
        return len(self._hosts)

    def idle_hosts(self) -> List[VirtualHost]:
        with self._lock:
            return [h for h in self._hosts.values()
                    if h.state == HostState.IDLE and not h.partitioned]

    def host(self, host_id: str) -> VirtualHost:
        return self._hosts[host_id]

    # ---- allocation ----------------------------------------------------
    def allocate(self, n: int, owner: str) -> List[VirtualHost]:
        """Claim n hosts (raises if capacity is insufficient) + boot cost."""
        with self._lock:
            idle = [h for h in self._hosts.values()
                    if h.state == HostState.IDLE and not h.partitioned]
            if len(idle) < n:
                raise CapacityError(
                    f"{self.name}: requested {n} hosts, {len(idle)} idle")
            got = idle[:n]
            for h in got:
                h.state = HostState.ALLOCATED
                h.owner = owner
        # the claim is visible (and notified) BEFORE the boot sleep: a
        # scheduler holding a capacity reservation for this owner must
        # drop it the instant the capacity counters reflect the claim,
        # or the hosts would be double-counted for the whole boot
        self._notify_allocation(owner, n)
        # boot cost: base + ceil(n / batch) * per_vm
        batches = -(-n // self.cost.alloc_batch_parallel)
        sim_sleep(self.cost.alloc_base_s + batches * self.cost.alloc_per_vm_s)
        return got

    def release(self, hosts: List[VirtualHost]) -> None:
        sim_sleep(self.cost.release_s)
        with self._lock:
            for h in hosts:
                if h.state != HostState.FAILED:
                    h.state = HostState.IDLE
                h.owner = None
                h.slowdown = 1.0
                self._channels.pop(h.host_id, None)
                # releasing a host must not punch a hole through a
                # whole-cloud outage: the partition belongs to the cloud,
                # not the owner
                if not self.in_outage:
                    h.partitioned = False
        self._notify_capacity()

    # ---- failures ------------------------------------------------------
    def fail_host(self, host_id: str) -> None:
        with self._lock:
            h = self._hosts[host_id]
            h.state = HostState.FAILED
            # a crashed host loses its channel AND every undelivered
            # message in it — the gang barrier must detect this, not
            # wait forever on an in-flight counter that can't drain
            self._channels.pop(host_id, None)
            listeners = list(self._failure_listeners)
        self._notify_fault("fail", host_id, 0.0)
        for cb in listeners:
            cb(h)

    def recover_host(self, host_id: str) -> None:
        with self._lock:
            h = self._hosts[host_id]
            h.state = HostState.IDLE
            h.owner = None
        self._notify_fault("recover", host_id, 0.0)
        self._notify_capacity()

    def degrade_host(self, host_id: str, slowdown: float) -> None:
        with self._lock:
            self._hosts[host_id].slowdown = slowdown
        self._notify_fault("degrade", host_id, slowdown)

    def partition_host(self, host_id: str) -> None:
        """Cut the host off the monitoring network without killing it.

        Unlike ``fail_host`` this fires no failure notification: the IaaS
        does not see partitions, so only the broadcast tree (or a native
        backend's unreachable-poll fallback) can detect it."""
        with self._lock:
            self._hosts[host_id].partitioned = True
        self._notify_fault("partition", host_id, 1.0)

    def heal_partition(self, host_id: str) -> None:
        with self._lock:
            self._hosts[host_id].partitioned = False
        self._notify_fault("partition", host_id, 0.0)
        self._notify_capacity()

    def cloud_outage(self) -> None:
        """Whole-cloud outage: every host — allocated or idle — becomes
        unreachable and no new capacity can be claimed until
        ``heal_outage``. Like ``partition_host``, the IaaS reports nothing:
        detection is entirely on the monitoring tree (and recovery is
        impossible on this backend — allocation raises CapacityError),
        which is exactly the situation cross-cloud standby failover
        (core/replication.py) exists for."""
        with self._lock:
            self.in_outage = True
            for h in self._hosts.values():
                h.partitioned = True
        self._notify_fault("outage", "*", 1.0)

    def heal_outage(self) -> None:
        with self._lock:
            self.in_outage = False
            for h in self._hosts.values():
                h.partitioned = False
        self._notify_fault("outage", "*", 0.0)
        self._notify_capacity()

    def on_failure(self, cb: Callable[[VirtualHost], None]) -> None:
        self._failure_listeners.append(cb)

    def on_fault(self, cb: Callable[[str, str, float], None]) -> None:
        """Subscribe to every injected fault: cb(kind, host_id, value).

        The chaos harness (core/chaos.py) uses this to build its replayable
        event trace; anything else (metrics, logging) can tap it too."""
        self._fault_listeners.append(cb)

    def on_capacity(self, cb: Callable[[], None]) -> None:
        """Subscribe to capacity-freed events: cb() fires after hosts
        become allocatable again (release, host recovery, partition/outage
        heal). The event-driven ``GlobalScheduler`` keys its scheduling
        passes on this instead of polling the wall clock."""
        self._capacity_listeners.append(cb)

    def on_allocation(self, cb: Callable[[str, int], None]) -> None:
        """Subscribe to allocation claims: ``cb(owner, n)`` fires the
        moment n hosts are claimed for ``owner`` (before the boot cost is
        paid). The scheduler releases its capacity reservation for that
        owner here — the sim's own counters carry the claim from now on."""
        self._allocation_listeners.append(cb)

    def _notify_fault(self, kind: str, host_id: str, value: float) -> None:
        for cb in list(self._fault_listeners):
            cb(kind, host_id, value)

    def _notify_capacity(self) -> None:
        for cb in list(self._capacity_listeners):
            cb()

    def _notify_allocation(self, owner: str, n: int) -> None:
        for cb in list(self._allocation_listeners):
            cb(owner, n)

    def is_reachable(self, host_id: str) -> bool:
        with self._lock:
            h = self._hosts[host_id]
            return h.state == HostState.ALLOCATED and not h.partitioned


    # ---- message transport (gang checkpointing) ------------------------
    # Per-VM message channels with in-flight counters: the simulated
    # TCP/InfiniBand fabric a distributed N-VM application exchanges
    # messages over (paper §2: "parallel and distributed computations").
    # A message is *in flight* from send until the destination host
    # receives it; the gang barrier (core/gang.py) drains these counters
    # to zero before snapshotting, so no message is lost in the cut —
    # the Chandy-Lamport / DMTCP quiesce-and-drain step made concrete.
    def channel_open(self, host_id: str) -> None:
        with self._lock:
            if host_id not in self._hosts:
                raise KeyError(f"unknown host {host_id}")
            self._channels.setdefault(host_id, [])

    def channel_close(self, host_id: str) -> None:
        with self._lock:
            self._channels.pop(host_id, None)

    def channel_send(self, src_host: str, dst_host: str, payload) -> None:
        """Deliver ``payload`` into ``dst_host``'s channel (one fabric hop).

        Raises :class:`ChannelError` when either endpoint is dead,
        partitioned, or has no open channel — a partitioned rank cannot
        talk to its peers, which is exactly what the gang barrier's
        fault detection keys on."""
        sim_sleep(self.cost.hop_latency_s)
        with self._lock:
            if not self._reachable_locked(src_host):
                raise ChannelError(f"send from unreachable host {src_host}")
            if not self._reachable_locked(dst_host):
                raise ChannelError(f"send to unreachable host {dst_host}")
            box = self._channels.get(dst_host)
            if box is None:
                raise ChannelError(f"no open channel on {dst_host}")
            box.append(payload)
            self.messages_sent += 1

    def channel_probe(self, host_id: str) -> None:
        """Control-plane ping over the fabric (one hop, delivers nothing).

        The gang barrier probes each rank at every phase boundary: a
        crashed or partitioned rank cannot echo, so the probe raises
        :class:`ChannelError` and the epoch aborts instead of waiting on
        an ack that can never arrive. Probes carry no payload so they
        never pollute the in-flight counters the drain phase freezes."""
        sim_sleep(self.cost.hop_latency_s)
        with self._lock:
            if not self._reachable_locked(host_id):
                raise ChannelError(f"probe: host {host_id} unreachable")
            if host_id not in self._channels:
                raise ChannelError(f"probe: no open channel on {host_id}")

    def channel_recv(self, host_id: str) -> List:
        """Drain and return every message currently in the host's channel
        (empties the in-flight counter for those messages)."""
        with self._lock:
            box = self._channels.get(host_id)
            if box is None:
                return []
            got, self._channels[host_id] = box, []
            self.messages_received += len(got)
            return got

    def channel_inflight(self, host_ids: Optional[List[str]] = None) -> int:
        """Messages sent but not yet received, summed over ``host_ids``
        (None = every open channel) — the gang drain-phase barrier
        condition is this hitting zero."""
        with self._lock:
            ids = self._channels.keys() if host_ids is None else host_ids
            return sum(len(self._channels.get(h, ())) for h in ids)

    def _reachable_locked(self, host_id: str) -> bool:
        h = self._hosts.get(host_id)
        return (h is not None and h.state == HostState.ALLOCATED
                and not h.partitioned)


class CapacityError(RuntimeError):
    pass


class ChannelError(RuntimeError):
    """A message-transport endpoint is unreachable (crash / partition)."""


def fresh_id(kind: str) -> str:
    return f"{kind}-{uuid.uuid4().hex[:10]}"
