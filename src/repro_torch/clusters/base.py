"""Cloud-agnostic cluster backend API (the paper's EC2-shaped Cloud Manager
boundary, §3.3/§6.1).

The CACS service only talks to this interface. Backends differ exactly the
way the paper's do: Snooze exposes native failure notifications; OpenStack
does not (so CACS runs its own monitoring agents); and a Local backend
stands in for the user's desktop (cloudification source, §7.3.1).

Port of ``repro/clusters/base.py``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

from repro_torch.clusters.simulator import (ClusterSim, CostModel, HostState,
                                            VirtualHost, fresh_id, sim_sleep)


class VMState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    TERMINATED = "terminated"
    FAILED = "failed"


@dataclasses.dataclass
class VMTemplate:
    vcpus: int = 1
    memory_gb: int = 2
    image: str = "ubuntu-13.10-x86_64-dmtcp"


@dataclasses.dataclass
class VMHandle:
    vm_id: str
    host: VirtualHost
    state: VMState = VMState.RUNNING

    @property
    def reachable(self) -> bool:
        return (self.state == VMState.RUNNING
                and self.host.state == HostState.ALLOCATED
                and not self.host.partitioned)


class ClusterBackend:
    """EC2-shaped VM management API."""

    name: str = "abstract"
    supports_failure_notifications: bool = False

    def allocate_vms(self, n: int, template: VMTemplate,
                     owner: str) -> List[VMHandle]:
        raise NotImplementedError

    def terminate_vms(self, vms: List[VMHandle]) -> None:
        raise NotImplementedError

    def describe_vms(self, vms: List[VMHandle]) -> Dict[str, VMState]:
        raise NotImplementedError

    def subscribe_failures(self, cb: Callable[[VMHandle], None]) -> None:
        raise NotImplementedError(
            f"{self.name} has no failure-notification API")

    def capacity(self) -> int:
        raise NotImplementedError


class SimBackend(ClusterBackend):
    """Shared implementation over the cluster simulator."""

    def __init__(self, sim: ClusterSim):
        self.sim = sim
        self._vms: Dict[str, VMHandle] = {}
        self._vm_by_host: Dict[str, VMHandle] = {}

    def allocate_vms(self, n: int, template: VMTemplate,
                     owner: str) -> List[VMHandle]:
        hosts = self.sim.allocate(n, owner)
        out = []
        for h in hosts:
            vm = VMHandle(vm_id=fresh_id("vm"), host=h)
            self._vms[vm.vm_id] = vm
            self._vm_by_host[h.host_id] = vm
            out.append(vm)
        return out

    def terminate_vms(self, vms: List[VMHandle]) -> None:
        for vm in vms:
            vm.state = VMState.TERMINATED
            self._vm_by_host.pop(vm.host.host_id, None)
        self.sim.release([vm.host for vm in vms])

    def describe_vms(self, vms: List[VMHandle]) -> Dict[str, VMState]:
        out = {}
        for vm in vms:
            if vm.state == VMState.TERMINATED:
                out[vm.vm_id] = VMState.TERMINATED
            elif vm.host.state == HostState.FAILED:
                out[vm.vm_id] = VMState.FAILED
            else:
                out[vm.vm_id] = vm.state
        return out

    def capacity(self) -> int:
        return len(self.sim.idle_hosts())
