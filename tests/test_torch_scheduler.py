"""The port's GlobalScheduler against the reference's.

Parity: a seeded ``WorkloadTrace`` of ``SimulatedApp`` jobs over two clouds,
and the outage storyline of ``tests/test_scheduler_chaos.py`` (a VM crash,
then a whole-cloud outage that the scheduler requeues and backfills onto
the surviving cloud), give the same ``decision_trace()`` in
``repro.core`` and ``repro_torch.core``, each package on its own
``SimClock``. Then the contracts of ``tests/test_scheduler.py`` held
against the port: preemption by swap-out and resume, all-or-nothing
preemption, every blocking call outside the scheduler lock, aging, the
queue across a service restart, and cross-cloud backfill with zero chunk
re-uploads.
"""
import importlib
import time
import types

import pytest
import torch

from repro_torch.ckpt import InMemoryStore
from repro_torch.ckpt.reader import list_steps
from repro_torch.ckpt.storage import FaultyStore
from repro_torch.clusters import OpenStackBackend, SnoozeBackend
from repro_torch.core import (ASR, CACSService, CheckpointPolicy, CoordState,
                              GlobalScheduler, ImageReplicator,
                              ReplicationPolicy, SimulatedApp, StandbyTarget)
from repro_torch.sim import SimClock, active_clock, install_clock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _package(root):
    """The names a scenario needs, from ``repro`` or ``repro_torch``."""
    core = importlib.import_module(f"{root}.core")
    clusters = importlib.import_module(f"{root}.clusters")
    sim = importlib.import_module(f"{root}.sim")
    return types.SimpleNamespace(
        InMemoryStore=importlib.import_module(f"{root}.ckpt").InMemoryStore,
        SnoozeBackend=clusters.SnoozeBackend,
        OpenStackBackend=clusters.OpenStackBackend,
        VirtualClock=importlib.import_module(f"{root}.core.chaos")
        .VirtualClock,
        SimClock=sim.SimClock, install_clock=sim.install_clock,
        active_clock=sim.active_clock,
        **{n: getattr(core, n) for n in (
            "ASR", "CACSService", "CheckpointPolicy", "CoordState",
            "GlobalScheduler", "SimulatedApp", "WorkloadTrace",
            "ImageReplicator", "ReplicationPolicy", "StandbyTarget",
            "ChaosController", "FaultEvent", "FaultKind", "FaultSchedule")})


PACKAGES = [_package("repro"), _package("repro_torch")]


def _on_own_clock(P, fn, *args):
    """Run ``fn(P, *args)`` on a fresh SimClock of ``P``'s own package."""
    clk = P.SimClock()
    prev = P.install_clock(clk)
    try:
        return fn(P, *args)
    finally:
        clk.close()
        P.install_clock(prev)


def _parity(fn, *args):
    ref, ours = (_on_own_clock(P, fn, *args) for P in PACKAGES)
    return ref, ours


# ---------------------------------------------------------------------------
# decision-trace parity
# ---------------------------------------------------------------------------

class _StepClock:
    """Scheduler clock that moves only when the scenario moves it: queue
    waits, and so aging, then depend on the script and not on how long the
    placements took on the pool threads."""
    t = 0.0

    def now(self):
        return self.t


def _workload(P, seed, aging_rate):
    """A seeded WorkloadTrace over two clouds, submitted in arrival order
    with the scheduler quiesced after each job, then drained: the running
    job first by name finishes, one at a time. The scheduler's clock steps
    to each job's arrival and one second for each finish."""
    backends = {"snooze": P.SnoozeBackend(n_hosts=5),
                "openstack": P.OpenStackBackend(n_hosts=4)}
    svc = P.CACSService(backends, {"default": P.InMemoryStore()})
    clock = _StepClock()
    sched = P.GlobalScheduler(svc, clock=clock, aging_rate=aging_rate)
    svc.attach_scheduler(sched)

    def quiesce():
        for _ in range(400):
            if sched.tick() == 0 and sched.inflight_depth == 0:
                return
            P.active_clock().sleep(0.01)
        raise AssertionError("scheduler did not quiesce")

    trace = P.WorkloadTrace.generate(seed, n_jobs=8,
                                     backends=("snooze", "openstack"),
                                     max_vms=4, max_priority=9)
    try:
        for job in trace.jobs:
            clock.t = job.arrival_s
            sched.submit(P.ASR(
                name=job.name, n_vms=job.n_vms, backend=job.backend,
                priority=job.priority,
                app_factory=lambda: P.SimulatedApp(iter_time_s=0.5,
                                                   state_mb=0.005),
                policy=P.CheckpointPolicy(period_s=0)))
            quiesce()
        for _ in range(12):
            quiesce()
            running = sorted((c for c in svc.db.list()
                              if c.state == P.CoordState.RUNNING),
                             key=lambda c: c.asr.name)
            if not running:
                break
            clock.t += 1.0
            svc.delete_coordinator(running[0].coord_id)
        return {"jobs": [_job_tuple(j) for j in trace.jobs],
                "decisions": [t[1:] for t in sched.decision_trace()],
                "stats": sched.stats()}
    finally:
        sched.stop()
        svc.shutdown()


def _job_tuple(job):
    return (job.name, job.arrival_s, job.n_vms, job.priority,
            job.duration_iters, job.backend)


@pytest.mark.parametrize("seed,aging_rate", [(2, 0.0), (42, 0.0), (7, 5.0)])
def test_workload_decision_trace_equals_the_reference(seed, aging_rate):
    ref, ours = _parity(_workload, seed, aging_rate)
    assert ours["jobs"] == ref["jobs"]
    assert ours["decisions"] == ref["decisions"]
    assert ours["stats"] == ref["stats"]
    ops = {d[0] for d in ours["decisions"]}
    assert {"submit", "start"} <= ops
    if seed == 42:
        assert ours["stats"]["preemptions"] > 0 and "resume" in ops


def _outage(P, seed, record_lock):
    """The storyline of tests/test_scheduler_chaos.py: one replicated job
    on cloud A, a VM crash (recovered in place), then a whole-cloud outage
    of A (requeue, then backfill onto B)."""
    a = P.SnoozeBackend(n_hosts=8)
    b = P.OpenStackBackend(n_hosts=8)
    store_a, store_b = P.InMemoryStore(), P.InMemoryStore()
    svc = P.CACSService({"snooze": a, "openstack": b},
                        {"default": store_a, "standby": store_b})
    rep = P.ImageReplicator(svc)
    rep.add_target(P.StandbyTarget("openstack", store=store_b,
                                   backend="openstack"))
    svc.attach_replicator(rep)
    sched = P.GlobalScheduler(svc, clock=P.VirtualClock(),
                              cloud_stores={"snooze": "default",
                                            "openstack": "standby"})
    svc.attach_scheduler(sched)
    sightings = []
    if record_lock:
        for name in ("suspend", "resume", "restart_from", "start_queued"):
            orig = getattr(svc.apps, name)

            def wrapper(*args, _orig=orig, _name=name, **kw):
                sightings.append((_name, sched.lock_held()))
                return _orig(*args, **kw)

            setattr(svc.apps, name, wrapper)
    sched.start()
    rep.start()
    try:
        cid = sched.submit(P.ASR(
            name=f"chaos-{seed}", n_vms=4, backend="snooze", priority=5,
            app_factory=lambda: P.SimulatedApp(iter_time_s=0.2,
                                               state_mb=0.02),
            policy=P.CheckpointPolicy(period_s=0.2, keep_last=3)))
        svc.wait_for_state(cid, P.CoordState.RUNNING, 30)
        svc.trigger_checkpoint(cid)
        rep.watch(cid, P.ReplicationPolicy(targets=("openstack",)))
        rep.sync()
        schedule = P.FaultSchedule(seed=seed, events=[
            P.FaultEvent(at_s=2.0, kind=P.FaultKind.VM_CRASH,
                         vm_index=seed % 4),
            P.FaultEvent(at_s=8.0, kind=P.FaultKind.CLOUD_OUTAGE)])
        ctrl = P.ChaosController(svc, cid, a, schedule, scheduler=sched,
                                 settle_timeout_s=60)
        outcomes = ctrl.run()
        coord = svc.db.get(cid)
        deadline = time.monotonic() + 30
        while (time.monotonic() < deadline
               and not (coord.state == P.CoordState.RUNNING
                        and sched.backfills >= 1)):
            P.active_clock().sleep(0.01)
        return {"ok": all(o.ok for o in outcomes),
                "trace": [o.trace_key() for o in outcomes],
                "decisions": [t[1:] for t in sched.decision_trace()],
                "backend": coord.asr.backend, "state": coord.state.value,
                "counts": (sched.backfills, sched.requeues,
                           sched.backfill_reuploads),
                "restarts": coord.app.restarts if coord.app else -1,
                "sightings": sightings}
    finally:
        sched.stop()
        rep.stop()
        svc.shutdown()


@pytest.mark.parametrize("seed", [7, 11])
def test_outage_storyline_decision_trace_equals_the_reference(seed):
    ref, ours = _parity(_outage, seed, seed == 7)
    assert ours["ok"] and ref["ok"], (ours["trace"], ref["trace"])
    assert ours["trace"] == ref["trace"]
    assert ours["decisions"] == ref["decisions"]
    assert [d[0] for d in ours["decisions"]] == \
        ["submit", "start", "requeue", "backfill"]
    assert (ours["state"], ours["backend"]) == ("RUNNING", "openstack")
    assert ours["counts"] == ref["counts"] == (1, 1, 0)
    assert ours["restarts"] >= 2
    if seed == 7:
        ops = [op for op, _ in ours["sightings"]]
        assert "suspend" in ops or "restart_from" in ops
        assert not any(held for _, held in ours["sightings"]), \
            ours["sightings"]


# ---------------------------------------------------------------------------
# the contracts of tests/test_scheduler.py, in the port
# ---------------------------------------------------------------------------

@pytest.fixture
def sim_time():
    clk = SimClock()
    prev = install_clock(clk)
    try:
        yield clk
    finally:
        clk.close()
        install_clock(prev)


@pytest.fixture
def env(sim_time):
    backend = SnoozeBackend(n_hosts=8)
    svc = CACSService({"snooze": backend}, {"default": InMemoryStore()})
    sched = GlobalScheduler(svc)
    svc.attach_scheduler(sched)
    yield svc, sched, backend
    sched.stop()
    svc.shutdown()


def _until(cond, timeout=20.0):
    """Wait for a counter the pool thread bumps after the state it waits
    on is already visible (``_finish_resume`` counts after ``resume``)."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        active_clock().sleep(0.01)


def _asr(name, n_vms, priority, backend="snooze", **kw):
    return ASR(name=name, n_vms=n_vms, backend=backend, priority=priority,
               app_factory=lambda: SimulatedApp(iter_time_s=0.5,
                                                state_mb=0.01),
               policy=CheckpointPolicy(period_s=0), **kw)


def test_high_priority_preempts_low_and_low_resumes(env):
    svc, sched, _ = env
    low = sched.submit(_asr("low", 6, priority=1))
    svc.wait_for_state(low, CoordState.RUNNING, 20)
    hi = sched.submit(_asr("hi", 6, priority=9))
    svc.wait_for_state(hi, CoordState.RUNNING, 20)
    assert svc.db.get(low).state == CoordState.SUSPENDED
    assert sched.preemptions == 1
    svc.delete_coordinator(hi)
    sched.tick()
    coord = svc.wait_for_state(low, CoordState.RUNNING, 20)
    _until(lambda: sched.resumes == 1)
    assert coord.app.restarts == 1
    assert [t[1] for t in sched.decision_trace()] == \
        ["submit", "start", "submit", "preempt", "start", "resume"]
    assert svc.scheduler_stats()["preemptions"] == 1


def test_equal_priority_queues_and_no_futile_preemption(env):
    svc, sched, _ = env
    a = sched.submit(_asr("a", 3, priority=5))
    svc.wait_for_state(a, CoordState.RUNNING, 20)
    b = sched.submit(_asr("b", 6, priority=5))
    assert svc.db.get(b).state == CoordState.QUEUED
    c = sched.submit(_asr("c", 12, priority=9))   # fits nowhere, ever
    assert svc.db.get(c).state == CoordState.QUEUED
    assert svc.db.get(a).state == CoordState.RUNNING
    assert sched.preemptions == 0 and sched.queue_depth == 2
    svc.delete_coordinator(a)
    sched.tick()
    svc.wait_for_state(b, CoordState.RUNNING, 20)


def test_preemption_is_all_or_nothing(sim_time, monkeypatch):
    """When the second victim's swap-out write fails, the first victim is
    resumed and the high-priority job stays queued; once the fault clears
    the retry preempts both."""
    backend = SnoozeBackend(n_hosts=8)
    store = FaultyStore(InMemoryStore())
    svc = CACSService({"snooze": backend}, {"default": store})
    sched = GlobalScheduler(svc)
    try:
        a = sched.submit(_asr("victim-a", 3, priority=1))
        b = sched.submit(_asr("victim-b", 3, priority=2))
        svc.wait_for_state(a, CoordState.RUNNING, 20)
        svc.wait_for_state(b, CoordState.RUNNING, 20)
        orig = svc.apps.suspend

        def failing_suspend(coord_id, reason="user"):
            if coord_id == b:
                store.arm_put_errors(1)
            return orig(coord_id, reason)

        monkeypatch.setattr(svc.apps, "suspend", failing_suspend)
        hi = sched.submit(_asr("hi", 8, priority=9))
        assert sched.aborted_preemptions == 1
        assert svc.db.get(a).state == CoordState.RUNNING
        assert svc.db.get(b).state == CoordState.RUNNING
        assert svc.db.get(hi).state == CoordState.QUEUED
        assert any(t[1] == "preempt_abort" for t in sched.decision_trace())
        store.disarm()
        monkeypatch.setattr(svc.apps, "suspend", orig)
        sched.tick()
        svc.wait_for_state(hi, CoordState.RUNNING, 20)
        assert svc.db.get(a).state == CoordState.SUSPENDED
        assert svc.db.get(b).state == CoordState.SUSPENDED
    finally:
        sched.stop()
        svc.shutdown()


def test_blocking_calls_run_outside_the_scheduler_lock(env, monkeypatch):
    svc, sched, _ = env
    seen = []
    for name in ("suspend", "resume", "start_queued"):
        orig = getattr(svc.apps, name)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, sched.lock_held()))
            return _orig(*a, **kw)

        monkeypatch.setattr(svc.apps, name, wrapper)
    sched.start()                        # event-driven loop this time
    low = sched.submit(_asr("low", 6, priority=1))
    svc.wait_for_state(low, CoordState.RUNNING, 20)
    hi = sched.submit(_asr("hi", 6, priority=9))
    svc.wait_for_state(hi, CoordState.RUNNING, 20)
    svc.delete_coordinator(hi)           # capacity event kicks the loop
    svc.wait_for_state(low, CoordState.RUNNING, 20)
    assert {"suspend", "resume", "start_queued"} <= {n for n, _ in seen}
    assert not any(held for _, held in seen), seen
    assert not sched.lock_held()


def test_aging_promotes_long_waiting_jobs(env):
    svc, _, _ = env

    class FakeClock:
        t = 0.0

        def now(self):
            return self.t

    clock = FakeClock()
    sched = GlobalScheduler(svc, clock=clock, aging_rate=1.0)
    try:
        blocker = sched.submit(_asr("blocker", 8, priority=9))
        svc.wait_for_state(blocker, CoordState.RUNNING, 20)
        x = sched.submit(_asr("x", 8, priority=5))      # queued at t=0
        clock.t = 4.0
        y = sched.submit(_asr("y", 8, priority=6))      # queued at t=4
        clock.t = 8.0
        assert sched.effective_priority(svc.db.get(x)) == 13
        assert sched.effective_priority(svc.db.get(y)) == 10
        svc.delete_coordinator(blocker)
        sched.tick()
        svc.wait_for_state(x, CoordState.RUNNING, 20)
        assert svc.db.get(y).state == CoordState.QUEUED
        # the age credit defends the aged job against y's base priority
        assert sched.defense_priority(svc.db.get(x)) == 13
    finally:
        sched.stop()


def test_queue_persists_across_a_service_restart(sim_time):
    db_store = InMemoryStore()
    svc1 = CACSService({"snooze": SnoozeBackend(n_hosts=4)},
                       {"default": InMemoryStore()}, db_store=db_store)
    sched1 = GlobalScheduler(svc1)
    blocker = sched1.submit(_asr("blocker", 4, priority=5))
    svc1.wait_for_state(blocker, CoordState.RUNNING, 20)
    queued = sched1.submit(_asr("waiter", 4, priority=3))
    assert svc1.db.get(queued).state == CoordState.QUEUED
    sched1.stop()                        # a crash: only the daemons die
    svc1.apps.stop_daemons()
    svc2 = CACSService({"snooze": SnoozeBackend(n_hosts=4)},
                       {"default": InMemoryStore()}, db_store=db_store)
    try:
        rec = svc2.db.get(queued)
        assert rec.state == CoordState.QUEUED
        assert "queued_at_v" in rec.metrics
        for coord in svc2.db.list():     # code is not persisted
            coord.asr.app_factory = lambda: SimulatedApp(iter_time_s=0.5)
        sched2 = GlobalScheduler(svc2)
        sched2.tick()
        coord = svc2.wait_for_state(queued, CoordState.RUNNING, 20)
        assert coord.app.device == torch.device("cpu")
        sched2.stop()
    finally:
        svc2.shutdown()
        svc1.provision.close()


def test_cross_cloud_backfill_reuploads_nothing(sim_time):
    """A preempted job whose swap-out image is fully replicated on another
    cloud resumes there through prefix adoption with zero chunk
    re-uploads, restored onto the CPU its app declares, and its next save
    commits to the new cloud's store."""
    a = SnoozeBackend(n_hosts=8)
    b = OpenStackBackend(n_hosts=4)
    store_a, store_b = InMemoryStore(), InMemoryStore()
    svc = CACSService({"snooze": a, "openstack": b},
                      {"default": store_a, "standby": store_b})
    rep = ImageReplicator(svc)
    rep.add_target(StandbyTarget("openstack", store=store_b,
                                 backend="openstack"))
    svc.attach_replicator(rep)
    sched = GlobalScheduler(svc, cloud_stores={"snooze": "default",
                                               "openstack": "standby"})
    svc.attach_scheduler(sched)
    sched.start()
    rep.start()
    try:
        low = sched.submit(_asr("low", 4, priority=1))
        svc.wait_for_state(low, CoordState.RUNNING, 20)
        svc.trigger_checkpoint(low)
        rep.watch(low, ReplicationPolicy(targets=("openstack",)))
        hi = sched.submit(_asr("hi", 8, priority=9, clouds=("snooze",)))
        svc.wait_for_state(hi, CoordState.RUNNING, 20)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            c = svc.db.get(low)
            if (c.state == CoordState.RUNNING
                    and c.asr.backend == "openstack"):
                break
            active_clock().sleep(0.02)
        c = svc.db.get(low)
        assert (c.state, c.asr.backend) == (CoordState.RUNNING, "openstack")
        _until(lambda: sched.backfills == 1)
        assert sched.backfill_reuploads == 0
        assert c.metrics["backfill_reuploads"] == 0
        assert c.asr.policy.store == "standby"
        assert c.app.restarts == 1
        step = svc.trigger_checkpoint(low)
        assert step in list_steps(store_b, c.ckpt_prefix)
        state = svc.ckpt.load(c, step)
        assert state["state"].device.type == "cpu"
    finally:
        sched.stop()
        rep.stop()
        svc.shutdown()
