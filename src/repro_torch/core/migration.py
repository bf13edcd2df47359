"""Cross-cloud migration, cloning and cloudification (paper §5.3, §7.3).

All three scenarios are compositions of the same three REST calls the paper
uses: POST /coordinators (create), POST .../checkpoints (upload image),
POST .../checkpoints/:id (restart) — applied across *two service instances*
running on different cloud backends:

  * ``clone``    — copy a checkpoint image to another cloud and start a
                   second instance there (source keeps running);
  * ``migrate``  — clone + terminate the source (paper's migration);
  * ``cloudify`` — migrate from the Local ("desktop") backend to a cloud
                   (paper §7.3.1's NS-3 scenario).

Because checkpoint images are topology-agnostic (repro_torch.ckpt.layout), the
destination may use a different VM count / mesh shape — the analogue of
migrating between heterogeneous clouds. The paper demonstrated this
Snooze→OpenStack (§7.3.2, Table 3); here any two `clusters/` backends work,
and `examples/cloud_migration.py` is the §7.3 scenario end-to-end (for the
reference package).

Image transfer goes through CheckpointManager.upload_image, which resolves
chunks via the source manifest and dedups on ingest (content-addressed
chunks the destination already holds are not re-uploaded) — repeated
migrations of a slowly-changing job cost only the delta, the same economics
docs/architecture.md describes for the write path. The transfer itself runs
on the destination service's parallel data plane (DataPlaneConfig
upload_workers concurrent chunk copies), so the ``transfer_s`` term of
MigrationResult — the dominant cost of cross-cloud migration in the paper's
Table 3 — scales with stream count on latency/bandwidth-bound links.

When an ImageReplicator (core/replication.py) has been keeping the
destination cloud warm, migration upgrades further: upload_image sources
every already-replicated chunk from the destination-side replica, so the
inter-cloud link carries only the unreplicated delta and ``transfer_s``
collapses (benchmarks/replication.py measures cold vs warm side by side).

Failure containment: a clone/migrate that dies mid-flight (upload fault,
destination never reaching RUNNING) must leave the *source untouched* and
must not leak the half-created destination coordinator — the destination
record is torn down before the error propagates, and ``migrate`` only
terminates the source after the clone has fully succeeded.

Port of ``repro/core/migration.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.core.coordinator import ASR, CoordState
from repro_torch.core.service import CACSService


@dataclasses.dataclass
class MigrationResult:
    src_id: str
    dst_id: str
    step: int
    checkpoint_s: float
    transfer_s: float
    restart_s: float

    @property
    def total_s(self) -> float:
        return self.checkpoint_s + self.transfer_s + self.restart_s


def clone(src: CACSService, coord_id: str, dst: CACSService, *,
          backend: str, n_vms: Optional[int] = None,
          step: Optional[int] = None, fresh_checkpoint: bool = True,
          ) -> MigrationResult:
    """Clone a running application onto another cloud (paper §5.3 case 2)."""
    src_coord = src.db.get(coord_id)

    t0 = time.monotonic()
    if fresh_checkpoint:
        step = src.trigger_checkpoint(coord_id, blocking=True)
    elif step is None:
        step = src.ckpt.latest(src_coord)
        if step is None:
            raise RuntimeError(f"{coord_id} has no checkpoint to clone from")
    t1 = time.monotonic()

    # 1. POST /coordinators on the destination (do not auto-start the app:
    #    submission here creates the record; bring-up happens at restart).
    new_asr = dataclasses.replace(
        src_coord.asr, backend=backend,
        n_vms=n_vms if n_vms is not None else src_coord.asr.n_vms)
    dst_coord = dst.db.create(new_asr)

    try:
        # 2. POST .../checkpoints — upload the image (n chunk objects).
        src_store = src.ckpt.store(src_coord.asr.policy.store)
        dst.upload_checkpoint(dst_coord.coord_id, src_store,
                              src_coord.ckpt_prefix, step)
        t2 = time.monotonic()

        # 3. POST .../checkpoints/:id — restart on the destination cloud.
        #    Passive recovery allocates + provisions the new virtual cluster.
        dst.restart_from(dst_coord.coord_id, step)
        dst.wait_for_state(dst_coord.coord_id, CoordState.RUNNING, timeout=60)
        t3 = time.monotonic()
    except BaseException:
        # The clone failed mid-flight. The source keeps running untouched
        # (its image is still committed in its own store); the half-created
        # destination coordinator — record, any uploaded chunks, any VMs a
        # partial restart claimed — must not leak.
        _cleanup_failed_clone(dst, dst_coord.coord_id)
        raise

    return MigrationResult(
        src_id=coord_id, dst_id=dst_coord.coord_id, step=step,
        checkpoint_s=t1 - t0, transfer_s=t2 - t1, restart_s=t3 - t2)


def _cleanup_failed_clone(dst: CACSService, dst_id: str) -> None:
    """Tear down the destination side of a failed clone, never masking the
    original error (cleanup failures are swallowed: the record may already
    be gone, or the destination store may itself be the faulty party)."""
    try:
        dst.delete_coordinator(dst_id)
    except Exception:                          # noqa: BLE001
        try:
            dst.db.remove(dst_id)              # at least drop the record
        except Exception:                      # noqa: BLE001
            pass


def migrate(src: CACSService, coord_id: str, dst: CACSService, *,
            backend: str, n_vms: Optional[int] = None) -> MigrationResult:
    """Migration = clone + terminate on the source cloud (paper §5.3).

    The source is only terminated after the destination is verifiably
    RUNNING — a clone that fails at any point propagates its error with
    the source still running and the destination cleaned up, so a failed
    migration never strands the job."""
    result = clone(src, coord_id, dst, backend=backend, n_vms=n_vms)
    src.delete_coordinator(coord_id)
    return result


def cloudify(local: CACSService, coord_id: str, cloud: CACSService, *,
             backend: str, n_vms: int) -> MigrationResult:
    """Desktop -> cloud migration (paper §7.3.1). The app's libraries travel
    inside the checkpoint image, so the destination needs no preinstall."""
    return migrate(local, coord_id, cloud, backend=backend, n_vms=n_vms)
