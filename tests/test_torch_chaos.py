"""The port's fault injection against the reference's.

The same seeds through ``repro.core.chaos`` and ``repro_torch.core.chaos``,
each package on its own ``SimClock``, give the same fault schedules, the
same outcome ``trace_key()``s, simulator fault firings, recoveries and
final states for ``run_scenario``, and, for a gang job under mid-barrier
faults, the same ``barrier_trace()`` of the ported gang barrier and the
same ``run_gang_scenario`` outcomes. Two parts of a barrier trace depend
on thread timing in both packages and are left out of the comparison:
drain rows, whose in-flight counts depend on same-instant thread wakes
(``tests/test_gang.py`` drops their payloads too) and, when a host fails
mid-drain, whose number depends on which rank's channel still holds
messages for it; and an ack that lands after its timeout, which shows as
a retry row and a later attempt number. What remains is the protocol:
each epoch's begin, phases, the ranks that acked, and its commit or
abort with the reason.

The scenarios run on ``SimClock``s with a longer wall pause before each
jump of the clock than the default: the barrier's ack timeouts and the
monitor's progress watchdog are virtual, so a thread that a loaded host
leaves unscheduled for longer than the pause would see its deadline pass
(a spurious straggler or a spurious low-performance suspend).
"""
import importlib
import types

import pytest
import torch

from repro_torch.core import (GANG_KINDS, ChaosHealthHook, FaultEvent,
                              FaultKind, FaultSchedule)
from repro_torch.core.chaos import SINGLE_CLOUD_KINDS, VirtualClock
from repro_torch.sim import SimClock, install_clock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _package(root):
    core = importlib.import_module(f"{root}.core")
    return types.SimpleNamespace(
        core=core, sim=importlib.import_module(f"{root}.sim"),
        SnoozeBackend=importlib.import_module(f"{root}.clusters")
        .SnoozeBackend,
        FaultyStore=importlib.import_module(f"{root}.ckpt.storage")
        .FaultyStore,
        InMemoryStore=importlib.import_module(f"{root}.ckpt").InMemoryStore)


REF, PORT = _package("repro"), _package("repro_torch")


def _on_own_clock(P, fn, *args, grace_s=0.003):
    """Run ``fn(P, *args)`` on a fresh SimClock of ``P``'s own package,
    with ``grace_s`` of wall pause before each jump of the clock."""
    clk = P.sim.SimClock(grace_s=grace_s)
    prev = P.sim.install_clock(clk)
    try:
        return fn(P, *args)
    finally:
        clk.close()
        P.sim.install_clock(prev)


def _events(schedule):
    return [(e.at_s, e.kind.value, e.vm_index, e.slowdown, e.n_ops, e.n_vms,
             e.phase) for e in schedule.events]


@pytest.mark.parametrize("seed", [3, 4, 42])
def test_fault_schedules_equal_the_reference(seed):
    J = REF.core.FaultSchedule
    assert _events(FaultSchedule.generate(seed, n_events=6)) == \
        _events(J.generate(seed, n_events=6))
    assert _events(FaultSchedule.storyline(seed)) == \
        _events(J.storyline(seed))
    assert FaultSchedule.storyline(seed).describe() == \
        J.storyline(seed).describe()
    assert [k.value for k in FaultKind] == \
        [k.value for k in REF.core.FaultKind]
    assert [k.value for k in SINGLE_CLOUD_KINDS] == [
        k.value for k in importlib.import_module(
            "repro.core.chaos").SINGLE_CLOUD_KINDS]
    assert [k.value for k in GANG_KINDS] == \
        [k.value for k in REF.core.GANG_KINDS]


def _scenario(P, kind, seed):
    FS = P.core.FaultSchedule
    schedule = (FS.storyline(seed) if kind == "storyline"
                else FS.generate(seed, n_events=4))
    r = P.core.run_scenario(schedule, settle_timeout_s=60)
    return {"trace": r.trace, "sim_faults": r.sim_faults,
            "final": r.final_state, "recoveries": r.recoveries,
            "all_ok": r.all_ok, "deduped": r.events_deduped,
            "fallbacks": r.partition_fallbacks,
            "detected_by": [o.detected_by for o in r.outcomes],
            "trace_ids": [o.trace_id for o in r.outcomes]}


@pytest.mark.parametrize("kind,seed", [("generate", 9), ("storyline", 42)])
def test_run_scenario_outcomes_equal_the_reference(kind, seed):
    ref = _on_own_clock(REF, _scenario, kind, seed)
    ours = _on_own_clock(PORT, _scenario, kind, seed)
    assert ours == ref
    assert ours["all_ok"] and ours["final"] == "RUNNING"
    assert ours["recoveries"] >= 3
    if kind == "storyline":
        assert [t[0] for t in ours["trace"]] == [
            "vm_crash", "storage_put_fault", "app_failure",
            "monitor_partition", "storage_get_fault", "host_slowdown"]
        assert ours["detected_by"][-1] == "telemetry"


def _gang_schedule(P, seed):
    """The mid-barrier storyline of ``tests/test_gang_chaos.py`` without
    its straggler: each of these faults fires at a protocol position, while
    a straggler races a slowed rank's sleep against the ack budget in wall
    time, which a loaded host can tip either way in either package."""
    FE, FK = P.core.FaultEvent, P.core.FaultKind
    return P.core.FaultSchedule(seed=seed, events=[
        FE(at_s=2.0, kind=FK.GANG_BARRIER_PUT_FAULT, vm_index=seed % 4,
           n_ops=3, phase="save"),
        FE(at_s=14.0, kind=FK.GANG_BARRIER_PARTITION,
           vm_index=(seed + 2) % 4, phase="drain"),
        FE(at_s=26.0, kind=FK.GANG_BARRIER_CRASH,
           vm_index=(seed + 3) % 4, phase="drain")])


def _gang_barrier(P, seed):
    """``run_gang_scenario``'s set-up, driven here so the job's gang
    coordinator can be read before the service shuts down."""
    c = P.core
    backend = P.SnoozeBackend(n_hosts=8)
    store = P.FaultyStore(P.InMemoryStore())
    svc = c.CACSService({backend.name: backend}, {"default": store})
    cid = svc.submit(c.ASR(
        name=f"gang-{seed}", n_vms=4, backend=backend.name,
        app_factory=lambda: c.GangApp(global_rows=16, iter_time_s=0.05),
        policy=c.CheckpointPolicy(period_s=0.0, keep_last=3), gang=True,
        min_vms=2, straggler_action="ignore"))
    try:
        svc.wait_for_state(cid, c.CoordState.RUNNING, timeout=60)
        svc.trigger_checkpoint(cid)
        outcomes = c.ChaosController(svc, cid, backend,
                                     _gang_schedule(P, seed), store=store,
                                     settle_timeout_s=120).run()
        gang = svc.apps.gang(cid)
        return {"barrier": [(tid, step, tag,
                             detail.split("/")[0] if tag == "ack"
                             else detail)
                            for tid, step, tag, detail
                            in gang.barrier_trace()
                            if tag not in ("retry", "drain")],
                "trace": [o.trace_key() for o in outcomes],
                "ok": [o.ok for o in outcomes],
                "stats": {k: v for k, v in gang.stats().items()
                          if k in ("epochs_started", "epochs_committed",
                                   "aborts")}}
    finally:
        svc.shutdown()


def test_gang_barrier_trace_equals_the_reference():
    ref = _on_own_clock(REF, _gang_barrier, 3)
    ours = _on_own_clock(PORT, _gang_barrier, 3)
    assert ours == ref
    assert all(ours["ok"])
    tags = [t[2] for t in ours["barrier"]]
    assert tags.count("abort") == 3 and "committed" in tags
    reasons = [t[3] for t in ours["barrier"] if t[2] == "abort"]
    assert reasons == ["store_fault", "partition_or_crash",
                       "partition_or_crash"]


def _gang_scenario(P, seed):
    r = P.core.run_gang_scenario(_gang_schedule(P, seed),
                                 settle_timeout_s=120)
    return {"trace": r.trace, "ok": r.all_ok, "final": r.final_state,
            "trace_ids": [o.trace_id for o in r.outcomes],
            "sim_faults": [f[0] for f in r.sim_faults]}


def test_run_gang_scenario_outcomes_equal_the_reference():
    ref = _on_own_clock(REF, _gang_scenario, 5)
    ours = _on_own_clock(PORT, _gang_scenario, 5)
    assert ours == ref
    assert ours["ok"] and ours["final"] == "RUNNING"
    assert all(t.startswith("tr-gang-5-") for t in ours["trace_ids"])


def test_virtual_clock_and_health_hook():
    clk = SimClock()
    prev = install_clock(clk)
    try:
        vc = VirtualClock()
        assert vc.now() == 0.0
        vc.sleep_until(12.5)
        assert vc.now() == pytest.approx(12.5)
        hook = ChaosHealthHook()
        assert hook() is True
        hook.arm(2)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="injected"):
                hook()
        assert hook() is True
    finally:
        clk.close()
        install_clock(prev)
    ev = FaultEvent(at_s=3.0, kind=FaultKind.VM_CRASH, vm_index=2)
    assert ev.label() == "vm_crash@3.0s/vm2"
