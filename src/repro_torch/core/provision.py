"""Provision Manager (paper §4.2/§6.5): prepares a virtual cluster to run.

Faithfully models the paper's two optimizations and their limit:
  * parallel SSH connections — a thread pool;
  * connection re-use — the first command to a VM pays ``connect_s``,
    subsequent ones don't;
  * a configured maximum of concurrent SSH sessions (16 in the paper's
    setup) — beyond 16 VMs provisioning time grows again (Fig 3a).

Port of ``repro/core/provision.py``.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Iterable, Sequence

from repro_torch.clusters.base import VMHandle
from repro_torch.clusters.simulator import CostModel, sim_sleep

MAX_SSH_SESSIONS = 16

# Internal provisioning actions (paper §5.1: checkpoint dir creation,
# checkpointer install/config) + user-defined commands from the ASR.
INTERNAL_CMDS = ("mkdir -p /ckpt", "install-checkpoint-agent",
                 "configure-checkpoint-policy")


class ProvisionManager:
    def __init__(self, max_sessions: int = MAX_SSH_SESSIONS):
        self.max_sessions = max_sessions
        self._pool = cf.ThreadPoolExecutor(max_workers=max_sessions,
                                           thread_name_prefix="ssh")
        self._connected: set = set()
        self._lock = threading.Lock()

    def provision(self, vms: Sequence[VMHandle],
                  user_cmds: Iterable[str] = (),
                  cost: CostModel = CostModel()) -> float:
        """Run all provisioning commands on all VMs. Returns elapsed time."""
        cmds = list(INTERNAL_CMDS) + list(user_cmds)

        def one_vm(vm: VMHandle) -> None:
            with self._lock:
                new_conn = vm.vm_id not in self._connected
                self._connected.add(vm.vm_id)
            if new_conn:
                sim_sleep(cost.ssh_connect_s)
            for _ in cmds:
                sim_sleep(cost.ssh_cmd_s)

        t0 = time.monotonic()
        futures = [self._pool.submit(one_vm, vm) for vm in vms]
        for f in futures:
            f.result()
        return time.monotonic() - t0

    def forget(self, vms: Sequence[VMHandle]) -> None:
        with self._lock:
            for vm in vms:
                self._connected.discard(vm.vm_id)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
