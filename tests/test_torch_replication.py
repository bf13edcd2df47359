"""The port's image replication and cross-cloud failover against the
reference's.

Parity: ``run_failover_scenario(seed)`` (a primary and a standby service
on two simulated clouds, continuous replication, a seeded whole-cloud
outage, automatic failover) gives the reference's trace, failover step,
target, zero re-uploads and final states, each package on its own
``SimClock``. The iterations it reports (what the restored image held,
where the primary was when its cloud died) depend on thread timing in
both packages, so they are held to their invariants, not to equality.
The scenario restores onto the device the standby application declares:
the CPU for ``SimulatedApp``, with or without a GPU. Then the replicator's
contracts of ``tests/test_replication.py`` held against the port.
"""
import importlib

import pytest
import torch

from repro_torch.ckpt import FaultyStore, InMemoryStore
from repro_torch.ckpt import reader as treader
from repro_torch.ckpt.reader import list_steps
from repro_torch.clusters import OpenStackBackend, SnoozeBackend
from repro_torch.core import (ASR, CACSService, CheckpointPolicy, CoordState,
                              FailoverController, ImageReplicator,
                              ReplicationPolicy, SimulatedApp, StandbyTarget,
                              run_failover_scenario)
from repro_torch.sim import SimClock, active_clock, install_clock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _on_own_clock(root, fn, *args, **kw):
    sim = importlib.import_module(f"{root}.sim")
    clk = sim.SimClock()
    prev = sim.install_clock(clk)
    try:
        return fn(*args, **kw)
    finally:
        clk.close()
        sim.install_clock(prev)


def _fields(res):
    fo = res.failover
    return {"trace": res.trace, "primary": res.primary_final_state,
            "standby": res.standby_state, "ok": fo.ok, "step": fo.step,
            "target": fo.target, "reuploads": fo.chunks_reuploaded,
            "error": fo.error, "outage_at_s": res.outage_at_s}


@pytest.mark.parametrize("seed,kw", [(11, {}), (23, {"outage_at_s": 10.0}),
                                     (7, {"continuous_replication": False,
                                          "period_s": 0.05})])
def test_failover_scenario_equals_the_reference(seed, kw):
    jrun = importlib.import_module("repro.core").run_failover_scenario
    ref = _on_own_clock("repro", jrun, seed, **kw)
    ours = _on_own_clock("repro_torch", run_failover_scenario, seed, **kw)
    assert _fields(ours) == _fields(ref)
    assert _fields(ours)["trace"] == [
        ("cloud_outage", 0, True, "TERMINATED", "outage")]
    assert ours.failover.ok and ours.failover.chunks_reuploaded == 0
    assert (ours.primary_final_state, ours.standby_state) == \
        ("TERMINATED", "RUNNING")
    assert ours.failover.mttr_s is not None and ours.failover.mttr_s > 0
    for r in (ours, ref):
        assert 0 <= r.restored_iteration <= r.primary_iteration
        assert r.iterations_lost == r.primary_iteration - \
            r.restored_iteration
    stats = ours.replication["targets"]["standby"]
    assert stats["images_replicated"] >= 1
    assert stats["errors"] == ref.replication["targets"]["standby"]["errors"]


def test_failover_scenario_restores_onto_the_standby_apps_device(
        monkeypatch):
    """With no GPU, the scenario still runs: it restores onto the CPU that
    ``SimulatedApp`` declares, passed explicitly, never by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    real = treader.restore

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(treader, "restore", spy)
    res = _on_own_clock("repro_torch", run_failover_scenario, 11)
    assert res.failover.ok and res.standby_state == "RUNNING"
    assert seen and all(d == torch.device("cpu") for d in seen), seen
    with pytest.raises(RuntimeError, match="device='cpu'"):
        real(InMemoryStore(), "apps/none", 1)     # no device, no GPU


# ---------------------------------------------------------------------------
# the replicator's contracts, in the port
# ---------------------------------------------------------------------------

@pytest.fixture
def pair():
    clk = SimClock()
    prev = install_clock(clk)
    src_store, dst_store = InMemoryStore(), FaultyStore(InMemoryStore())
    src = CACSService({"snooze": SnoozeBackend(8)}, {"default": src_store})
    dst = CACSService({"openstack": OpenStackBackend(8)},
                      {"default": dst_store})
    try:
        yield src, src_store, dst, dst_store
    finally:
        src.shutdown()
        dst.shutdown()
        clk.close()
        install_clock(prev)


def _submit(svc, state_mb=0.05):
    cid = svc.submit(ASR(
        name="repl", n_vms=2, backend="snooze",
        app_factory=lambda: SimulatedApp(iter_time_s=0.2, state_mb=state_mb),
        policy=CheckpointPolicy(period_s=0.0, keep_last=3)))
    svc.wait_for_state(cid, CoordState.RUNNING, 30)
    return cid


def _replicator(src, dst, dst_store, **policy_kw):
    rep = ImageReplicator(src)
    rep.add_target(StandbyTarget("standby", store=dst_store, service=dst,
                                 backend="openstack"))
    return rep, ReplicationPolicy(targets=("standby",), **policy_kw)


def test_ships_only_missing_chunks_and_commits_last(pair):
    """The standby holds only fully replicated images: a torn ship stays
    invisible and the next pass heals it; a second image re-ships only the
    chunks the standby lacks."""
    src, src_store, dst, dst_store = pair
    cid = _submit(src)
    s1 = src.trigger_checkpoint(cid)
    rep, pol = _replicator(src, dst, dst_store)
    rep.watch(cid, pol)
    prefix = src.db.get(cid).ckpt_prefix
    dst_store.arm_put_errors(1)
    rep.sync()
    assert list_steps(dst_store, prefix) == []
    assert rep.sync_errors >= 1
    assert rep.replication_stats(cid)["targets"]["standby"]["errors"] >= 1
    dst_store.disarm()
    rep.sync()
    assert list_steps(dst_store, prefix) == [s1]
    s2 = src.trigger_checkpoint(cid)
    rep.sync()
    stats = rep.replication_stats(cid)["targets"]["standby"]
    assert list_steps(dst_store, prefix) == [s1, s2]
    assert stats["last_step"] == s2 and stats["lag_images"] == 0
    assert stats["rpo_s"] == 0.0 and stats["within_budget"]
    assert stats["chunks_skipped"] >= 1         # the unchanged leaf
    assert rep.best_standby(cid) == (rep.target("standby"), s2)
    # a replicated image restores from the standby onto the CPU
    state, _ = treader.restore(dst_store, prefix, s2, device="cpu")
    assert state["state"].device.type == "cpu"


def test_lag_budget_and_primary_gc(pair):
    src, src_store, dst, dst_store = pair
    cid = _submit(src)
    src.trigger_checkpoint(cid)
    rep, pol = _replicator(src, dst, dst_store, lag_budget_s=1e-9)
    rep.watch(cid, pol)
    rep.sync()
    active_clock().sleep(0.02)                 # commit-time gap > budget
    src.trigger_checkpoint(cid)
    src.trigger_checkpoint(cid)
    stats = rep.replication_stats(cid)["targets"]["standby"]
    assert stats["lag_images"] == 2 and stats["rpo_s"] > 0
    assert not stats["within_budget"]
    for _ in range(3):                         # keep_last=3 prunes 1..2
        src.trigger_checkpoint(cid)
        rep.sync()
    prefix = src.db.get(cid).ckpt_prefix
    assert list_steps(dst_store, prefix) == list_steps(src_store, prefix)
    stats = rep.replication_stats(cid)["targets"]["standby"]
    assert stats["lag_images"] == 0 and stats["within_budget"]
    assert stats["steps_pruned"] >= 1
    assert "replication_lag_s:standby" in src.db.get(cid).metrics


def test_failover_without_replica_fails_loudly(pair):
    src, src_store, dst, dst_store = pair
    cid = _submit(src)
    src.trigger_checkpoint(cid)
    rep, pol = _replicator(src, dst, dst_store)
    rep.watch(cid, pol)                        # watched but never synced
    with pytest.raises(RuntimeError, match="fully replicated"):
        FailoverController(src, rep).failover(cid)
    assert not dst.list_coordinators()


def test_explicit_failover_restarts_on_the_standby(pair):
    """An operator-driven failover (no outage) restarts the job on the
    standby from the replicated image: the standby coordinator adopts the
    primary's prefix, nothing is re-uploaded, and the facade reports the
    replication."""
    src, src_store, dst, dst_store = pair
    cid = _submit(src)
    rep, pol = _replicator(src, dst, dst_store)
    src.attach_replicator(rep)
    assert src.replication_stats(cid) == {}
    rep.watch(cid, pol)
    step = src.trigger_checkpoint(cid)
    rep.sync()
    assert src.replication_stats(cid)["targets"]["standby"][
        "images_replicated"] == 1
    put0 = dst_store.inner.put_count
    prefix = src.db.get(cid).ckpt_prefix
    res = FailoverController(src, rep).failover(cid)
    assert res.ok and res.step == step and res.chunks_reuploaded == 0
    coord = dst.db.get(res.dst_id)
    assert coord.state == CoordState.RUNNING
    assert coord.ckpt_prefix == prefix
    assert coord.app.restarts == 1 and coord.app.iteration >= 0
    assert cid not in {c["id"] for c in src.list_coordinators()}
    assert dst_store.inner.put_count == put0   # the restart wrote nothing
