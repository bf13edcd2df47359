"""Snooze-like backend: small-cloud latency profile + NATIVE failure
notifications (paper §6.1: "Snooze provides a server and VM failure
notification API that can be directly used by the Monitoring Manager").

Port of ``repro/clusters/snooze.py``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.clusters.base import SimBackend, VMHandle
from repro_torch.clusters.simulator import ClusterSim, CostModel


# Calibrated to Fig 6a: Snooze processes VM submissions quickly.
SNOOZE_COST = CostModel(alloc_base_s=4.0, alloc_per_vm_s=0.6,
                        alloc_batch_parallel=8, ssh_cmd_s=0.5,
                        ssh_connect_s=1.0)


class SnoozeBackend(SimBackend):
    name = "snooze"
    supports_failure_notifications = True

    def __init__(self, n_hosts: int = 128):
        super().__init__(ClusterSim(n_hosts, SNOOZE_COST, name="snooze"))

    def subscribe_failures(self, cb: Callable[[VMHandle], None]) -> None:
        def on_host_failure(host):
            vm = self._vm_by_host.get(host.host_id)
            if vm is not None:
                cb(vm)
        self.sim.on_failure(on_host_failure)
