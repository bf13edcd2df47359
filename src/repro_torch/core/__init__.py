"""CACS — Cloud-Agnostic Checkpointing Service (the paper's contribution),
port of ``repro/core`` for one job.

Public surface:
  * ``CACSService``       — REST-style facade (paper Table 1)
  * ``ASR``               — Application Submission Request (paper §5.1)
  * ``migration``         — clone / migrate / cloudify (paper §5.3, §7.3)

An image restores onto the device its application declares
(``app.device``): ``TrainerApp`` and ``ServeApp`` name their card,
``SimulatedApp`` and ``GangApp`` the CPU; an application that names none
is refused. The reference's ``chaos``, ``replication`` and ``scheduler``
modules (the global scheduler, image replication and failover, the
fault-injection harness) are not ported yet: they are the next slice of
the port (ROADMAP, queue 1: the rest of the control plane), and nothing
here imports them.
"""
from repro_torch.core.application import (Application, AppContext,
                                          SimulatedApp, snapshot_of)
from repro_torch.core.coordinator import (ASR, CheckpointPolicy, Coordinator,
                                          CoordinatorDB, CoordState,
                                          InvalidTransition)
from repro_torch.core.gang import (BarrierConfig, GangApp, GangBarrierError,
                                   GangCoordinator, GangStragglerError,
                                   gang_invariant)
from repro_torch.core.migration import (MigrationResult, clone, cloudify,
                                        migrate)
from repro_torch.core.service import CACSService

__all__ = [
    "Application", "AppContext", "SimulatedApp", "snapshot_of",
    "ASR", "CheckpointPolicy", "Coordinator", "CoordinatorDB", "CoordState",
    "InvalidTransition",
    "BarrierConfig", "GangApp", "GangBarrierError", "GangCoordinator",
    "GangStragglerError", "gang_invariant",
    "clone", "cloudify", "migrate", "MigrationResult",
    "CACSService",
]
