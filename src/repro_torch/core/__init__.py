"""CACS — Cloud-Agnostic Checkpointing Service (the paper's contribution),
port of ``repro/core``.

Public surface:
  * ``CACSService``       — REST-style facade (paper Table 1)
  * ``ASR``               — Application Submission Request (paper §5.1)
  * ``GlobalScheduler``   — cloud-spanning job swapping / over-subscription
                            (use case 2): preemption, aging, cross-cloud
                            backfill over replicated images
  * ``ImageReplicator`` / ``FailoverController`` — warm standby clouds and
                            cross-cloud failover
  * ``ChaosController``   — seeded fault injection
  * ``migration``         — clone / migrate / cloudify (paper §5.3, §7.3)

An image restores onto the device its application declares
(``app.device``): ``TrainerApp`` and ``ServeApp`` name their card,
``SimulatedApp`` and ``GangApp`` the CPU; an application that names none
is refused.
"""
from repro_torch.core.application import (Application, AppContext,
                                          SimulatedApp, snapshot_of)
from repro_torch.core.chaos import (GANG_KINDS, ChaosController,
                                    ChaosHealthHook, FaultEvent, FaultKind,
                                    FaultOutcome, FaultSchedule,
                                    ScenarioResult, run_gang_scenario,
                                    run_scenario)
from repro_torch.core.coordinator import (ASR, CheckpointPolicy, Coordinator,
                                          CoordinatorDB, CoordState,
                                          InvalidTransition)
from repro_torch.core.gang import (BarrierConfig, GangApp, GangBarrierError,
                                   GangCoordinator, GangStragglerError,
                                   gang_invariant)
from repro_torch.core.migration import (MigrationResult, clone, cloudify,
                                        migrate)
from repro_torch.core.replication import (FailoverController, FailoverResult,
                                          FailoverScenarioResult,
                                          ImageReplicator, ReplicationPolicy,
                                          StandbyTarget,
                                          run_failover_scenario)
from repro_torch.core.scheduler import (GlobalScheduler, JobSpec,
                                        PlacementWeights, WorkloadTrace)
from repro_torch.core.service import CACSService

__all__ = [
    "Application", "AppContext", "SimulatedApp", "snapshot_of",
    "ASR", "CheckpointPolicy", "Coordinator", "CoordinatorDB", "CoordState",
    "InvalidTransition",
    "ChaosController", "ChaosHealthHook", "FaultEvent", "FaultKind",
    "FaultOutcome", "FaultSchedule", "ScenarioResult", "run_scenario",
    "GANG_KINDS", "run_gang_scenario",
    "BarrierConfig", "GangApp", "GangBarrierError", "GangCoordinator",
    "GangStragglerError", "gang_invariant",
    "clone", "cloudify", "migrate", "MigrationResult",
    "FailoverController", "FailoverResult", "FailoverScenarioResult",
    "ImageReplicator", "ReplicationPolicy", "StandbyTarget",
    "run_failover_scenario",
    "GlobalScheduler", "JobSpec", "PlacementWeights", "WorkloadTrace",
    "CACSService",
]
