"""OpenStack-like backend: production-cloud latency profile, NO failure
notification API (paper §3.3: "OpenStack does not provide an API to report
infrastructure failures to clients. So the CACS service must include a
cloud-agnostic monitoring system.").

Port of ``repro/clusters/openstack.py``.
"""
from __future__ import annotations

from repro_torch.clusters.base import SimBackend
from repro_torch.clusters.simulator import ClusterSim, CostModel

# Calibrated to Fig 6a: OpenStack VM allocation is markedly slower and
# scales worse with VM count than Snooze's.
OPENSTACK_COST = CostModel(alloc_base_s=12.0, alloc_per_vm_s=2.0,
                           alloc_batch_parallel=4, ssh_cmd_s=0.5,
                           ssh_connect_s=1.0)


class OpenStackBackend(SimBackend):
    name = "openstack"
    supports_failure_notifications = False

    def __init__(self, n_hosts: int = 128):
        super().__init__(ClusterSim(n_hosts, OPENSTACK_COST, name="openstack"))
