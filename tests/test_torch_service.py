"""The port's CACS service for one job: the contracts of
``tests/test_service.py`` held against ``repro_torch.core`` (lifecycle and
periodic checkpoints, both VM-failure paths and app failure, recovery to
the latest state, suspend/resume, proactive straggler suspend, service
restart, restart from an earlier image), the swap-codec suspend of
``tests/test_train_ckpt.py`` with a reduced f32 trainer on the CPU, the
device rule of ``CheckpointManager.load``, and images crossing from the
reference's service into the port's.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.ckpt import InMemoryStore
from repro_torch.clusters import OpenStackBackend, SnoozeBackend
from repro_torch.configs import get_config, reduced
from repro_torch.core import (ASR, CACSService, CheckpointPolicy, CoordState,
                              SimulatedApp)
from repro_torch.train.trainer import TrainerApp
from repro_torch.tree import tree_leaves

CFG = dataclasses.replace(reduced(get_config("repro-100m")), dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def snooze_svc():
    backend = SnoozeBackend(n_hosts=16)
    svc = CACSService({"snooze": backend}, {"default": InMemoryStore()})
    yield svc, backend
    svc.shutdown()


@pytest.fixture
def ostack_svc():
    backend = OpenStackBackend(n_hosts=16)
    svc = CACSService({"openstack": backend}, {"default": InMemoryStore()})
    yield svc, backend
    svc.shutdown()


def _submit(svc, backend_name, n_vms=4, period=0.15, **app_kw):
    asr = ASR(name="app", n_vms=n_vms, backend=backend_name,
              app_factory=lambda: SimulatedApp(iter_time_s=0.5, state_mb=0.05,
                                               **app_kw),
              policy=CheckpointPolicy(period_s=period, keep_last=3))
    cid = svc.submit(asr)
    svc.wait_for_state(cid, CoordState.RUNNING, timeout=30)
    return cid


def _wait_recovered(svc, cid, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        c = svc.db.get(cid)
        if c.recoveries >= n and c.state == CoordState.RUNNING:
            return c
        time.sleep(0.02)
    raise TimeoutError(f"no recovery #{n}; state={svc.db.get(cid).state}")


def _until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_lifecycle_and_periodic_checkpoints(snooze_svc):
    svc, _ = snooze_svc
    cid = _submit(svc, "snooze")
    time.sleep(0.7)
    cks = svc.list_checkpoints(cid)
    assert 2 <= len(cks) <= 3, f"periodic images / keep_last=3: {cks}"
    info = svc.get_checkpoint(cid, cks[-1])
    assert info["bytes"] > 0 and info["leaves"] >= 2
    final = svc.delete_coordinator(cid)
    assert final["state"] == "TERMINATED"
    assert not svc.ckpt.store().list(f"apps/{cid}")    # §5.4
    assert all(c["id"] != cid for c in svc.list_coordinators())


@pytest.mark.parametrize("fault", ["vm_native", "vm_polling", "app"])
def test_failure_recovers_from_an_image(fault, snooze_svc, ostack_svc):
    """A failed VM is replaced (Snooze by its notification, OpenStack by
    the agents' polling); a failed app restarts in place on the same
    VMs (paper §6.3). Either way the app resumes from an image."""
    svc, backend = ostack_svc if fault == "vm_polling" else snooze_svc
    cid = _submit(svc, backend.name)
    time.sleep(0.4)
    coord = svc.db.get(cid)
    vms_before = [vm.vm_id for vm in coord.vms]
    if fault == "app":
        coord.app.poison()
    else:
        backend.sim.fail_host(coord.vms[1].host.host_id)
    c = _wait_recovered(svc, cid, 1)
    assert c.app.restarts == 1
    assert c.app.iteration > 0
    assert all(vm.reachable for vm in c.vms)
    native = svc.apps.monitor.native_notifications
    if fault == "app":
        assert [vm.vm_id for vm in c.vms] == vms_before
    else:
        assert [vm.vm_id for vm in c.vms] != vms_before
        assert (native >= 1) if fault == "vm_native" else (native == 0)


def test_recovery_restores_latest_state(snooze_svc):
    svc, backend = snooze_svc
    cid = _submit(svc, "snooze")
    time.sleep(0.6)
    coord = svc.db.get(cid)
    it_at_ckpt = coord.app.checkpoint_state()["iteration"]
    backend.sim.fail_host(coord.vms[0].host.host_id)
    c = _wait_recovered(svc, cid, 1)
    time.sleep(0.2)
    assert c.app.iteration >= max(1, it_at_ckpt - 50)


def test_suspend_resume_preserves_progress(snooze_svc):
    svc, backend = snooze_svc
    cid = _submit(svc, "snooze")
    time.sleep(0.4)
    it_before = svc.db.get(cid).app.iteration
    svc.apps.suspend(cid)
    c = svc.db.get(cid)
    assert c.state == CoordState.SUSPENDED and not c.vms
    idle_during = len(backend.sim.idle_hosts())
    svc.apps.resume(cid)
    c = svc.db.get(cid)
    assert c.state == CoordState.RUNNING
    time.sleep(0.3)
    assert c.app.iteration >= it_before
    assert len(backend.sim.idle_hosts()) == idle_during - 4


def test_straggler_triggers_proactive_suspend(snooze_svc):
    svc, backend = snooze_svc
    cid = _submit(svc, "snooze", n_vms=8)
    time.sleep(0.3)
    coord = svc.db.get(cid)
    backend.sim.degrade_host(coord.vms[0].host.host_id, slowdown=100.0)
    _until(lambda: svc.db.get(cid).state == CoordState.SUSPENDED, 20)
    assert svc.list_checkpoints(cid)


def test_service_restart_rehydrates_and_resumes():
    """§6.4: a fresh service instance over the same stores rehydrates the
    record and, once an app factory is re-attached, restarts the job from
    its image onto the app's device."""
    ckpt_store, db_store = InMemoryStore(), InMemoryStore()
    factory = lambda: SimulatedApp(iter_time_s=0.5, state_mb=0.05)
    svc1 = CACSService({"snooze": SnoozeBackend(n_hosts=8)},
                       {"default": ckpt_store}, db_store=db_store)
    asr = ASR(name="app", n_vms=2, backend="snooze", app_factory=factory,
              policy=CheckpointPolicy(period_s=0, keep_last=3))
    cid = svc1.submit(asr)
    svc1.wait_for_state(cid, CoordState.RUNNING, timeout=30)
    time.sleep(0.2)
    step = svc1.trigger_checkpoint(cid)
    saved = svc1.ckpt.load(svc1.db.get(cid), step)
    assert saved["state"].device == torch.device("cpu")
    svc1.apps.stop_daemons()               # a crash: no terminate

    svc2 = CACSService({"snooze": SnoozeBackend(n_hosts=8)},
                       {"default": ckpt_store}, db_store=db_store)
    try:
        coord = svc2.db.get(cid)
        assert coord.state == CoordState.RUNNING
        assert coord.vms == [] and coord.app is None
        assert svc2.list_checkpoints(cid) == [step]
        coord.asr.app_factory = factory
        svc2.restart_from(cid, step)
        c = svc2.wait_for_state(cid, CoordState.RUNNING, timeout=30)
        assert c.app.iteration >= saved["iteration"]
        assert len(c.vms) == 2
    finally:
        svc2.shutdown()
        svc1.provision.close()


def test_restart_from_earlier_image(snooze_svc):
    svc, _ = snooze_svc
    cid = _submit(svc, "snooze", period=0.0)
    time.sleep(0.2)
    s1 = svc.trigger_checkpoint(cid)
    time.sleep(0.4)
    s2 = svc.trigger_checkpoint(cid)
    it_s2 = svc.db.get(cid).app.iteration
    svc.restart_from(cid, s1)              # the user picks an EARLIER image
    c = svc.db.get(cid)
    assert c.state == CoordState.RUNNING
    assert c.app.checkpoint_state()["iteration"] <= max(it_s2, 1)
    assert svc.get_checkpoint(cid, s1)["step"] == s1
    assert s2 in svc.list_checkpoints(cid)  # the newer image survives


def test_suspend_uses_swap_codec_and_resumes():
    """policy.swap_codec routes the suspend image through the device
    encode (the qsnap plain versions on the CPU); the explicit image stays
    lossless; the job resumes from the int8 image onto its device."""
    from repro_torch.kernels import qsnap
    backend = SnoozeBackend(4)
    svc = CACSService({"snooze": backend}, {"default": InMemoryStore()})
    try:
        asr = ASR(name="train", n_vms=1, backend="snooze",
                  app_factory=lambda: TrainerApp(CFG, global_batch=2,
                                                 seq_len=16, n_steps=200,
                                                 device="cpu"),
                  policy=CheckpointPolicy(period_s=0, codec="raw",
                                          swap_codec="int8"))
        cid = svc.submit(asr)
        svc.wait_for_state(cid, CoordState.RUNNING, 60)
        coord = svc.db.get(cid)
        _until(lambda: coord.app.current_step >= 1)
        ckpt_step = svc.apps.checkpoint_now(cid)     # lossless image
        svc.apps.suspend(cid)                        # int8 swap-out image
        suspend_step = ckpt_step + 1
        assert svc.get_checkpoint(cid, ckpt_step)["codec"] == "raw"
        info = svc.get_checkpoint(cid, suspend_step)
        assert info["codec"] == "int8"
        assert info["metadata"]["suspend"] == "user"
        n_float = sum(t.is_floating_point() for t in tree_leaves(
            coord.app.checkpoint_state()["state"]))
        assert info["leaves"] > n_float > 0
        svc.apps.resume(cid)
        coord = svc.db.get(cid)
        resumed_from = coord.app.current_step
        _until(lambda: coord.app.current_step >= resumed_from + 2)
        assert coord.app.restarts == 1
        assert coord.app.healthy()
        assert all(t.device.type == "cpu" for t in tree_leaves(
            coord.app.checkpoint_state()["state"]))
        assert qsnap.LAUNCHES == {"quantize": 0, "dequantize": 0}  # no card
    finally:
        svc.shutdown()


class _NoDeviceApp:
    """An application stand-in that names no device."""


def test_load_refuses_an_app_without_a_device(snooze_svc):
    svc, _ = snooze_svc
    cid = _submit(svc, "snooze", period=0.0)
    step = svc.trigger_checkpoint(cid)
    coord = svc.db.get(cid)
    assert svc.ckpt.load(coord, step)["state"].device.type == "cpu"
    app, coord.app = coord.app, _NoDeviceApp()
    try:
        with pytest.raises(ValueError, match="declares no device"):
            svc.ckpt.load(coord, step)
    finally:
        coord.app = app


def test_reference_service_image_resumes_in_the_port():
    """A SimulatedApp image that the reference's CACSService wrote is
    ingested by the port's ``upload_image`` and resumes with the same
    iteration and state, exactly."""
    import repro.ckpt as jckpt
    import repro.clusters as jclusters
    import repro.core as jcore
    jsvc = jcore.CACSService({"snooze": jclusters.SnoozeBackend(4)},
                             {"default": jckpt.InMemoryStore()})
    svc = CACSService({"snooze": SnoozeBackend(4)},
                      {"default": InMemoryStore()})
    try:
        jcid = jsvc.submit(jcore.ASR(
            name="app", n_vms=2, backend="snooze",
            app_factory=lambda: jcore.SimulatedApp(iter_time_s=0.5,
                                                   state_mb=0.05),
            policy=jcore.CheckpointPolicy(period_s=0)))
        jsvc.wait_for_state(jcid, jcore.CoordState.RUNNING, timeout=30)
        time.sleep(0.2)
        step = jsvc.trigger_checkpoint(jcid)
        jcoord = jsvc.db.get(jcid)
        want = jsvc.ckpt.load(jcoord, step)
        assert want["iteration"] > 0
        # n_iters stops the resumed app where the image left it
        coord = svc.db.create(ASR(
            name="app", n_vms=2, backend="snooze",
            app_factory=lambda: SimulatedApp(n_iters=want["iteration"],
                                             iter_time_s=0.5, state_mb=0.05),
            policy=CheckpointPolicy(period_s=0)))
        svc.upload_checkpoint(coord.coord_id, jsvc.ckpt.store(),
                              jcoord.ckpt_prefix, step)
        svc.restart_from(coord.coord_id, step)
        c = svc.wait_for_state(coord.coord_id, CoordState.RUNNING, 30)
        assert c.app.restarts == 1
        assert c.app.iteration == want["iteration"]
        assert np.array_equal(c.app.state, np.asarray(want["state"]))
        assert c.app.state.dtype == np.float64
    finally:
        svc.shutdown()
        jsvc.shutdown()


def test_reference_trainer_image_resumes_under_the_port_service():
    """A reduced repro-100m image that the reference TrainerApp wrote
    resumes under the port's service; its next losses follow the
    reference's own continuation within 1e-4 relative (f32 on the CPU,
    as tests/test_torch_trainer.py holds the two trainers)."""
    import repro.ckpt as jckpt
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.train import trainer as jtrainer
    k, more = 2, 2
    jcfg = dataclasses.replace(jreduced(jget("repro-100m")), dtype="float32")
    japp = jtrainer.TrainerApp(jcfg, global_batch=2, seq_len=32, n_steps=k)
    japp.start(None, None)
    _until(japp.is_done)
    japp.stop()
    jstore = jckpt.InMemoryStore()
    jckpt.save_checkpoint(jstore, "ref", k,
                          jax.device_get(japp.checkpoint_state()))
    japp.n_steps = k + more
    japp.start(None, None)
    _until(japp.is_done)
    japp.stop()

    svc = CACSService({"snooze": SnoozeBackend(4)},
                      {"default": InMemoryStore()})
    try:
        coord = svc.db.create(ASR(
            name="train", n_vms=1, backend="snooze",
            app_factory=lambda: TrainerApp(CFG, global_batch=2, seq_len=32,
                                           n_steps=k + more, device="cpu"),
            policy=CheckpointPolicy(period_s=0)))
        svc.upload_checkpoint(coord.coord_id, jstore, "ref", k)
        svc.restart_from(coord.coord_id, k)
        c = svc.wait_for_state(coord.coord_id, CoordState.RUNNING, 60)
        _until(c.app.is_done)
        assert c.app.restarts == 1
        assert len(c.app.losses) == more
        np.testing.assert_allclose(c.app.losses, japp.losses[k:], rtol=1e-4)
    finally:
        svc.shutdown()
