"""Cluster backends (port of ``repro/clusters``): the EC2-shaped VM API the
CACS service talks to, over a simulated IaaS data plane."""
from repro_torch.clusters.base import (ClusterBackend, SimBackend, VMHandle,
                                       VMState, VMTemplate)
from repro_torch.clusters.local import LocalBackend
from repro_torch.clusters.openstack import OpenStackBackend
from repro_torch.clusters.simulator import (CapacityError, ClusterSim,
                                            CostModel, HostState, VirtualHost,
                                            sim_sleep)
from repro_torch.clusters.snooze import SnoozeBackend

__all__ = [
    "ClusterBackend", "SimBackend", "VMHandle", "VMState", "VMTemplate",
    "LocalBackend", "OpenStackBackend", "SnoozeBackend",
    "CapacityError", "ClusterSim", "CostModel", "HostState", "VirtualHost",
    "sim_sleep",
]
