"""The port's discrete-event simulator and serving workload against the
reference's: the same seeds through ``repro.sim`` / ``repro.serve.workload``
and ``repro_torch.sim`` / ``repro_torch.serve.workload`` give the same
request arrivals, the same router choices and the same trace digests, for
``SimEngine`` and for the ``ServeFleetEngine`` built on it, at a few
dozen hosts (``tests/test_simscale.py`` holds the reference at 1,000).
"""
import pytest

from repro.serve.workload import FleetPolicy as JFleetPolicy
from repro.serve.workload import RequestTrace as JRequestTrace
from repro.serve.workload import Router as JRouter
from repro.sim import SimEngine as JSimEngine
from repro.sim import SimJob as JSimJob
from repro.sim.serve import PARKED as JPARKED
from repro.sim.serve import ServeFleetEngine as JServeFleetEngine
from repro_torch.serve import FleetPolicy, RequestTrace, Router
from repro_torch.sim import InvariantViolation, SimEngine, SimJob
from repro_torch.sim.serve import PARKED, ServeFleetEngine

TRACE_KW = dict(horizon_s=1800.0, base_qps=2.0, peak_qps=12.0,
                period_s=900.0, burst_every_s=300.0, burst_s=40.0,
                burst_mult=3.0)


@pytest.mark.parametrize("seed", [0, 13, 99])
def test_request_trace_arrivals_equal_the_reference(seed):
    ours = RequestTrace(seed=seed, **TRACE_KW)
    want = list(JRequestTrace(seed=seed, **TRACE_KW))
    assert list(ours) == want
    assert list(ours) == want              # every iter() restarts the stream
    assert ours.burst_windows() == \
        JRequestTrace(seed=seed, **TRACE_KW).burst_windows()
    assert len(want) > 100


def test_router_choices_equal_the_reference():
    """A scripted run of adds, routes, completions and removals: the same
    choice at every step (least outstanding, ties to the lowest id)."""
    ours, ref = Router(), JRouter()
    script = ([("route",)] + [("add", n) for n in ("r2", "r0", "r1")]
              + [("route",)] * 7 + [("complete", "r1"), ("route",),
                                     ("remove", "r0"), ("route",),
                                     ("complete", "r2"), ("add", "r3"),
                                     ("route",), ("route",), ("remove", "r1"),
                                     ("remove", "r2"), ("remove", "r3"),
                                     ("route",)])
    picks = []
    for op, *args in script:
        got = getattr(ours, op)(*args)
        assert got == getattr(ref, op)(*args), (op, args)
        picks.append(got)
        assert ours.members() == ref.members()
        assert ours.outstanding() == ref.outstanding()
    assert ours.routed == ref.routed and ours.rejected == ref.rejected == 2
    assert picks[4:7] == ["r0", "r1", "r2"]


def _engines(seed, n_hosts=48, n_jobs=150, horizon_s=6 * 3600.0, **kw):
    out = []
    for cls in (SimEngine, JSimEngine):
        eng = cls(n_hosts=n_hosts, seed=seed, host_mtbf_s=20_000.0, **kw)
        eng.load(n_jobs=n_jobs, horizon_s=horizon_s,
                 arrival_horizon_s=horizon_s / 2, mean_work_s=1800.0)
        eng.run()
        out.append(eng)
    return out


@pytest.mark.parametrize("seed", [3, 7, 8])
def test_sim_engine_trace_digest_equals_the_reference(seed):
    ours, ref = _engines(seed)
    assert ours.trace_digest() == ref.trace_digest()
    assert ours.trace_bytes() == ref.trace_bytes()
    assert (ours.now, ours.completed, ours.recoveries, ours.preemptions,
            ours.events_fired) == (ref.now, ref.completed, ref.recoveries,
                                   ref.preemptions, ref.events_fired)
    assert ours.completed == 150
    assert ours.recoveries > 0 and ours.preemptions > 0
    ours.check_invariants()


def test_sim_engine_aging_trace_equals_the_reference():
    ours, ref = _engines(5, aging_rate=0.01)
    assert ours.trace_digest() == ref.trace_digest()
    assert ours.completed == ref.completed == 150


def test_sim_engine_checks_its_arguments_like_the_reference():
    for cls in (SimEngine, JSimEngine):
        eng = cls(8, seed=3)
        eng.load(n_jobs=50, horizon_s=100.0, max_priority=5)
        assert all(1 <= j.priority <= 5 for j in eng.jobs)
        for bad in (0, 10):
            with pytest.raises(ValueError):
                eng.load(n_jobs=1, horizon_s=1.0, max_priority=bad)
    assert issubclass(InvariantViolation, AssertionError)
    assert list(SimJob.__dataclass_fields__) == \
        list(JSimJob.__dataclass_fields__)


def _des(mod, seed, policy=None, horizon_s=3600.0, n_jobs=20, **kw):
    trace_cls, policy_cls, eng_cls = mod
    trace = trace_cls(seed=seed, horizon_s=horizon_s, base_qps=4.0,
                      peak_qps=35.0, period_s=horizon_s / 2,
                      burst_every_s=600.0, burst_s=120.0, burst_mult=3.0)
    pol = policy or policy_cls(min_replicas=1, max_replicas=6,
                               target_util=0.7, scale_in_idle_s=30.0,
                               eval_period_s=5.0)
    eng = eng_cls(16, seed, trace=trace, policy=pol, service_s=0.1,
                  concurrency=2, replica_boot_s=5.0, suspend_s=2.0, **kw)
    eng.start_fleet(pol.min_replicas)
    eng.load(n_jobs=n_jobs, horizon_s=horizon_s, max_vms=4,
             mean_work_s=600.0, max_priority=8)
    eng.run()
    return eng


PORT = (RequestTrace, FleetPolicy, ServeFleetEngine)
REF = (JRequestTrace, JFleetPolicy, JServeFleetEngine)


@pytest.mark.parametrize("seed,mtbf", [(11, None), (5, 3000.0)])
def test_serve_fleet_engine_trace_digest_equals_the_reference(seed, mtbf):
    kw = {} if mtbf is None else {"host_mtbf_s": mtbf}
    ours, ref = _des(PORT, seed, **kw), _des(REF, seed, **kw)
    assert ours.trace_digest() == ref.trace_digest()
    assert ours.fleet_stats() == ref.fleet_stats()
    assert ours.served == ours.requests == ref.requests
    assert ours.parks > 0 and ours.coldstarts > 1
    if mtbf is not None:
        assert ours.recoveries == ref.recoveries > 0
    ours.check_invariants()
    assert PARKED == JPARKED
    assert all(ours.jobs[j].state == PARKED for j in ours.parked_jids)


def test_pooled_fleet_beats_static_in_the_port_as_in_the_reference():
    """The storm of ``tests/test_serve_fleet.py``'s pooled-versus-static
    claim, held in the port: a pooled fleet has the better p99 and the
    better served QPS per host-second than a static one on the same
    requests, with the reference's exact numbers."""
    stats = {}
    for name, mod in (("port", PORT), ("ref", REF)):
        pol = mod[1]
        pooled = _des(mod, 21, horizon_s=7200.0, n_jobs=30, policy=pol(
            min_replicas=1, max_replicas=8, target_util=0.7,
            scale_in_idle_s=30.0, eval_period_s=5.0))
        static = _des(mod, 21, horizon_s=7200.0, n_jobs=30, policy=pol(
            min_replicas=4, max_replicas=4, target_util=0.7,
            scale_in_idle_s=1e18, eval_period_s=5.0))
        stats[name] = (pooled.fleet_stats(), static.fleet_stats())
    assert stats["port"] == stats["ref"]
    ps, ss = stats["port"]
    assert ps["requests"] == ss["requests"]
    assert ps["p99_s"] < ss["p99_s"]
    assert ps["served_qps_per_host"] > ss["served_qps_per_host"]
