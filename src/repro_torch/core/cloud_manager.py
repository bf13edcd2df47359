"""Cloud Manager: cloud-agnostic virtual-cluster management (paper §4.2).

Holds a registry of named ``ClusterBackend``s and creates/destroys virtual
clusters on any of them through one API — the portability boundary the paper
demonstrates with Snooze + OpenStack.

Port of ``repro/core/cloud_manager.py``.
"""
from __future__ import annotations

import threading
from typing import Dict, List

from repro_torch.clusters.base import ClusterBackend, VMHandle, VMTemplate


class CloudManager:
    def __init__(self, backends: Dict[str, ClusterBackend]):
        self._backends = dict(backends)
        self._lock = threading.Lock()

    def backend(self, name: str) -> ClusterBackend:
        if name not in self._backends:
            raise KeyError(f"unknown cloud backend {name!r}; "
                           f"have {sorted(self._backends)}")
        return self._backends[name]

    def backends(self) -> Dict[str, ClusterBackend]:
        return dict(self._backends)

    def register(self, name: str, backend: ClusterBackend) -> None:
        with self._lock:
            self._backends[name] = backend

    def create_cluster(self, backend_name: str, n_vms: int,
                       template: VMTemplate, owner: str) -> List[VMHandle]:
        return self.backend(backend_name).allocate_vms(n_vms, template, owner)

    def destroy_cluster(self, backend_name: str,
                        vms: List[VMHandle]) -> None:
        live = [vm for vm in vms if vm.state.value != "terminated"]
        if live:
            self.backend(backend_name).terminate_vms(live)

    def replace_failed(self, backend_name: str, vms: List[VMHandle],
                       template: VMTemplate, owner: str) -> List[VMHandle]:
        """Passive recovery (paper §5.3): swap unreachable VMs for fresh ones."""
        backend = self.backend(backend_name)
        healthy = [vm for vm in vms if vm.reachable]
        dead = [vm for vm in vms if not vm.reachable]
        if not dead:
            return vms
        backend.terminate_vms(dead)
        fresh = backend.allocate_vms(len(dead), template, owner)
        return healthy + fresh

    def capacity(self, backend_name: str) -> int:
        return self.backend(backend_name).capacity()
