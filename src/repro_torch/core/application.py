"""Application abstraction hosted by CACS.

The service is application-agnostic (the paper's key requirement): anything
implementing this protocol can be checkpointed, swapped, and migrated. Two
implementations ship:
  * ``SimulatedApp``  — synthetic workload with configurable state size
    (stands in for the paper's dmtcp1 / NAS-LU targets; used by benchmarks).
  * ``TrainerApp``    — a real PyTorch training job
    (repro_torch.train.trainer), the 2026 analogue of a long-running MPI
    application.

Port of ``repro/core/application.py``. One addition to the contract: an
application names the torch ``device`` its state lives on, and the
control plane restores its images there (``CheckpointManager.load``).
``TrainerApp`` and ``ServeApp`` hold their card's device; ``SimulatedApp``
keeps numpy state on the host and declares the CPU.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.ckpt.snapshot import ReadySnapshot, SnapshotHandle
from repro_torch.clusters.simulator import sim_sleep


@runtime_checkable
class Application(Protocol):
    """CACS application contract.

    Staged-snapshot extension (optional): an application may additionally
    implement ``snapshot_async(step=None, codec=None) -> SnapshotHandle``
    — capture a consistent snapshot in microseconds (pin immutable state
    references under its lock) and defer materialization (device→host
    copy, or device-side encode when ``codec`` selects a lossy image) to
    ``handle.resolve()`` on the checkpoint writer thread. The control
    plane always goes through ``snapshot_of``, which falls back to
    wrapping the synchronous ``checkpoint_state`` for applications that
    don't implement it (``SimulatedApp``, gang ranks), so implementing
    the extension is purely a performance choice.
    """

    def start(self, ctx: "AppContext", restore_state: Optional[Any]) -> None:
        """Begin (or resume) execution. Non-blocking."""

    def checkpoint_state(self) -> Any:
        """Pytree snapshot of application state (step-consistent)."""

    def healthy(self) -> bool:
        """User-defined health hook (paper §6.3)."""

    device: torch.device
    """Where the application's state lives: its images restore here."""

    def stop(self) -> None:
        """Stop execution (state remains queryable until discarded)."""

    def is_done(self) -> bool: ...

    def progress(self) -> float: ...


def snapshot_of(app: Any, *, step: Optional[int] = None,
                codec: Optional[str] = None) -> SnapshotHandle:
    """Capture a staged snapshot of ``app`` (the control plane's one entry
    point for cutting application state).

    Applications implementing the staged extension return in microseconds
    with materialization deferred to ``resolve()``; legacy applications
    are wrapped in a ``ReadySnapshot`` around the synchronous
    ``checkpoint_state()`` — identical timing and bytes to the old path.
    ``codec`` is a hint for device-side encode ("int8"): apps that can't
    honor it (or lossless-only apps) simply ignore it — the image codec
    is chosen by the save, not here.
    """
    fn = getattr(app, "snapshot_async", None)
    if fn is not None:
        return fn(step=step, codec=codec)
    return ReadySnapshot(app.checkpoint_state(), step=step)


class AppContext:
    """What the service hands an application at start time. ``trace_id``
    is the job's, for the spans the application records (contexts made
    by other services may lack it: read it with ``getattr``)."""

    def __init__(self, coord_id: str, vms, service=None, trace_id: str = ""):
        self.coord_id = coord_id
        self.vms = vms
        self.service = service
        self.trace_id = trace_id


class SimulatedApp:
    """Iterative synthetic workload.

    Each iteration sleeps ``iter_time_s`` (scaled by the slowest host's
    ``slowdown`` — stragglers stretch it) and mutates an ndarray state of
    ``state_mb`` megabytes, like a time-stepping MPI solver. Health can be
    poisoned via ``poison()`` to exercise the paper's "application failure"
    recovery path (restart-in-place, §6.3 case 2).
    """

    device = torch.device("cpu")          # numpy state, on the host

    def __init__(self, n_iters: int = 1_000_000, iter_time_s: float = 0.2,
                 state_mb: float = 1.0):
        self.n_iters = n_iters
        self.iter_time_s = iter_time_s
        self.state_elems = max(1, int(state_mb * 1024 * 1024 / 8))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poisoned = False
        self.iteration = 0
        self.state = np.zeros(self.state_elems, np.float64)
        self.ctx: Optional[AppContext] = None
        self.restarts = 0

    # -- Application protocol -------------------------------------------
    def start(self, ctx: AppContext, restore_state: Optional[Any]) -> None:
        self.ctx = ctx
        if restore_state is not None:
            with self._lock:
                self.iteration = int(restore_state["iteration"])
                self.state = np.array(restore_state["state"], np.float64)
                self.restarts += 1
        self._stop.clear()
        self._poisoned = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set() and self.iteration < self.n_iters:
            slowdown = 1.0
            if self.ctx is not None and self.ctx.vms:
                slowdown = max(vm.host.slowdown for vm in self.ctx.vms)
            sim_sleep(self.iter_time_s * slowdown)
            with self._lock:
                self.state[self.iteration % self.state_elems] += 1.0
                self.iteration += 1

    def checkpoint_state(self) -> Dict[str, Any]:
        with self._lock:
            return {"iteration": self.iteration, "state": self.state.copy()}

    def healthy(self) -> bool:
        return not self._poisoned

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def is_done(self) -> bool:
        return self.iteration >= self.n_iters

    def progress(self) -> float:
        return self.iteration / max(self.n_iters, 1)

    # -- test hooks -------------------------------------------------------
    def poison(self) -> None:
        self._poisoned = True
