"""Local ("desktop") backend — the cloudification source (paper §7.3.1):
one host, no allocation latency. Checkpointing here and restoring on a real
backend migrates a legacy job into the cloud.

Port of ``repro/clusters/local.py``.
"""
from __future__ import annotations

from repro_torch.clusters.base import SimBackend
from repro_torch.clusters.simulator import ClusterSim, CostModel

LOCAL_COST = CostModel(alloc_base_s=0.0, alloc_per_vm_s=0.0,
                       ssh_cmd_s=0.05, ssh_connect_s=0.0, release_s=0.0)


class LocalBackend(SimBackend):
    name = "local"
    supports_failure_notifications = False

    def __init__(self, n_hosts: int = 1):
        super().__init__(ClusterSim(n_hosts, LOCAL_COST, name="local"))
