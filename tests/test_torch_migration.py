"""The port's cross-cloud migration, cloning and cloudification (paper
§5.3, §7.3): the contracts of ``tests/test_migration.py`` held between two
port services, the migrated reduced f32 training job on the CPU included."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.ckpt import ChaosStorageError, FaultyStore, InMemoryStore
from repro_torch.clusters import LocalBackend, OpenStackBackend, SnoozeBackend
from repro_torch.configs import get_config, reduced
from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                              CoordState, SimulatedApp, clone, cloudify,
                              migrate)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def two_clouds():
    src = CACSService({"snooze": SnoozeBackend(8)},
                      {"default": InMemoryStore()})
    dst = CACSService({"openstack": OpenStackBackend(8)},
                      {"default": InMemoryStore()})
    yield src, dst
    src.shutdown()
    dst.shutdown()


def _submit_sim(svc, backend, n_vms=2):
    asr = ASR(name="sim", n_vms=n_vms, backend=backend,
              app_factory=lambda: SimulatedApp(iter_time_s=0.3,
                                               state_mb=0.02),
              policy=CheckpointPolicy(period_s=0.2, keep_last=2))
    cid = svc.submit(asr)
    svc.wait_for_state(cid, CoordState.RUNNING, 30)
    return cid


def test_clone_keeps_source_running(two_clouds):
    src, dst = two_clouds
    cid = _submit_sim(src, "snooze")
    time.sleep(0.3)
    res = clone(src, cid, dst, backend="openstack")
    assert src.db.get(cid).state == CoordState.RUNNING
    c2 = dst.db.get(res.dst_id)
    assert c2.state == CoordState.RUNNING
    assert c2.app.restarts == 1
    assert c2.app.iteration > 0, "clone must resume from the image"


def test_migrate_terminates_source_and_changes_vm_count(two_clouds):
    src, dst = two_clouds
    cid = _submit_sim(src, "snooze", n_vms=4)
    time.sleep(0.3)
    it_before = src.db.get(cid).app.iteration
    res = migrate(src, cid, dst, backend="openstack", n_vms=2)
    assert all(c["id"] != cid for c in src.list_coordinators())
    c2 = dst.db.get(res.dst_id)
    assert c2.state == CoordState.RUNNING
    assert len(c2.vms) == 2, "heterogeneous migration: different VM count"
    time.sleep(0.3)
    assert c2.app.iteration >= it_before * 0.3


def test_cloudify_desktop_to_cloud():
    desktop = CACSService({"local": LocalBackend(1)},
                          {"default": InMemoryStore()})
    cloud = CACSService({"openstack": OpenStackBackend(8)},
                        {"default": InMemoryStore()})
    try:
        cid = _submit_sim(desktop, "local", n_vms=1)
        time.sleep(0.3)
        res = cloudify(desktop, cid, cloud, backend="openstack", n_vms=2)
        c2 = cloud.db.get(res.dst_id)
        assert c2.state == CoordState.RUNNING and c2.app.iteration > 0
    finally:
        desktop.shutdown()
        cloud.shutdown()


def test_clone_explicit_earlier_step(two_clouds):
    """fresh_checkpoint=False with an explicit committed step clones from
    exactly that image, not the newest one."""
    src, dst = two_clouds
    asr = ASR(name="sim", n_vms=2, backend="snooze",
              app_factory=lambda: SimulatedApp(iter_time_s=0.3,
                                               state_mb=0.02),
              policy=CheckpointPolicy(period_s=0, keep_last=3))
    cid = src.submit(asr)
    src.wait_for_state(cid, CoordState.RUNNING, 30)
    time.sleep(0.3)
    s1 = src.trigger_checkpoint(cid)
    it_s1 = src.ckpt.load(src.db.get(cid), s1)["iteration"]
    time.sleep(0.3)
    src.trigger_checkpoint(cid)               # a newer image exists
    res = clone(src, cid, dst, backend="openstack", step=s1,
                fresh_checkpoint=False)
    assert res.step == s1 and res.checkpoint_s < 0.05
    c2 = dst.db.get(res.dst_id)
    assert c2.state == CoordState.RUNNING
    # restored from s1: cannot have started beyond the newer image
    assert c2.app.restarts == 1
    assert c2.app.iteration >= it_s1


def test_clone_missing_explicit_step_raises_cleanly(two_clouds):
    """An explicit-but-missing step must raise (never restart from
    garbage) and must not leak a half-created destination record."""
    src, dst = two_clouds
    cid = _submit_sim(src, "snooze")
    src.trigger_checkpoint(cid)
    with pytest.raises(FileNotFoundError):
        clone(src, cid, dst, backend="openstack", step=999,
              fresh_checkpoint=False)
    assert src.db.get(cid).state == CoordState.RUNNING
    assert not dst.list_coordinators(), "failed clone leaked the dst record"


def test_failed_migration_leaves_source_running_and_no_dst_leak():
    """Regression (FaultyStore): if the transfer dies mid-upload, the
    source must be untouched and the half-created destination coordinator
    cleaned up — migrate only terminates the source after success."""
    faulty = FaultyStore(InMemoryStore())
    src = CACSService({"snooze": SnoozeBackend(8)},
                      {"default": InMemoryStore()})
    dst = CACSService({"openstack": OpenStackBackend(8)},
                      {"default": faulty})
    try:
        cid = _submit_sim(src, "snooze")
        time.sleep(0.2)
        faulty.arm_put_errors(1)              # first chunk put dies
        with pytest.raises((ChaosStorageError, IOError)):
            migrate(src, cid, dst, backend="openstack")
        # source untouched: still RUNNING, record intact, images intact
        c = src.db.get(cid)
        assert c.state == CoordState.RUNNING
        assert src.list_checkpoints(cid)
        # destination fully cleaned: no record, no committed images
        assert not dst.list_coordinators()
        faulty.disarm()
        # and the same migration succeeds once the store heals
        res = migrate(src, cid, dst, backend="openstack")
        assert dst.db.get(res.dst_id).state == CoordState.RUNNING
        assert all(ci["id"] != cid for ci in src.list_coordinators())
    finally:
        src.shutdown()
        dst.shutdown()


def test_migrated_training_job_is_bit_exact(two_clouds):
    """The paper's strongest claim, applied to a real PyTorch job: the
    migrated training run continues the exact optimizer/token trajectory,
    and its state lands on the app's device."""
    from repro_torch.train.trainer import TrainerApp
    from repro_torch.tree import tree_leaves
    src, dst = two_clouds
    cfg = dataclasses.replace(reduced(get_config("repro-100m")),
                              dtype="float32")
    n_total = 10

    # reference: uninterrupted 10 steps
    ref = TrainerApp(cfg, global_batch=2, seq_len=32, n_steps=n_total,
                     device="cpu")
    ref.start(None, None)
    while not ref.is_done():
        time.sleep(0.02)
    ref.stop()

    asr = ASR(name="train", n_vms=2, backend="snooze",
              app_factory=lambda: TrainerApp(cfg, global_batch=2, seq_len=32,
                                             n_steps=n_total, device="cpu"),
              policy=CheckpointPolicy(period_s=0))
    cid = src.submit(asr)
    src.wait_for_state(cid, CoordState.RUNNING, 60)
    while src.db.get(cid).app.current_step < 4:
        time.sleep(0.02)
    res = migrate(src, cid, dst, backend="openstack", n_vms=1)
    c2 = dst.db.get(res.dst_id)
    while not c2.app.is_done():
        time.sleep(0.05)
    c2.app.stop()
    assert c2.app.current_step == n_total
    np.testing.assert_allclose(c2.app.losses[-1], ref.losses[-1],
                               rtol=0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(c2.app.checkpoint_state()["state"]),
        tree_leaves(ref.checkpoint_state()["state"])))
