"""The port's health monitoring against the reference's, on the inputs of
``tests/test_monitoring.py``: broadcast-tree depth, heartbeat round trips,
unreachable and unhealthy VMs, straggler z-scores and uniform slowness
give equal results in both packages (VMs compared by position: ids are
random in each)."""
import importlib

import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                        # bare env: seeded fallback
    from _hypothesis_fallback import given, settings, strategies as st

PKGS = ["repro", "repro_torch"]


@pytest.fixture(autouse=True)
def _virtual_time():
    """Both packages on their discrete-event virtual clocks."""
    clocks = []
    for pkg in PKGS:
        sim = importlib.import_module(f"{pkg}.sim.simtime")
        clk = sim.SimClock()
        clocks.append((sim, clk, sim.install_clock(clk)))
    yield
    for sim, clk, prev in clocks:
        clk.close()
        sim.install_clock(prev)


def _run(pkg, scenario):
    clusters = importlib.import_module(f"{pkg}.clusters")
    mon = importlib.import_module(f"{pkg}.core.monitoring")
    return scenario(clusters.SnoozeBackend, mon.heartbeat_roundtrip)


def _report(rep, vms):
    pos = {vm.vm_id: i for i, vm in enumerate(vms)}
    return (rep.rtt_s, [pos[v] for v in rep.unreachable],
            [pos[v] for v in rep.unhealthy], [pos[v] for v in rep.stragglers],
            rep.ok)


def _rtts(Backend, hb):
    backend, out = Backend(n_hosts=256), {}
    for n in (1, 16, 256):
        vms = backend.allocate_vms(n, None, owner="t")
        out[n] = _report(hb(vms, lambda: True), vms)
        backend.terminate_vms(vms)
    return out


def _unreachable(Backend, hb):
    backend = Backend(n_hosts=8)
    vms = backend.allocate_vms(4, None, owner="t")
    backend.sim.fail_host(vms[2].host.host_id)
    return _report(hb(vms, lambda: True), vms)


def _unhealthy(Backend, hb):
    backend = Backend(n_hosts=8)
    vms = backend.allocate_vms(2, None, owner="t")
    return _report(hb(vms, lambda: False), vms)


def _straggler(Backend, hb):
    backend = Backend(n_hosts=32)
    vms = backend.allocate_vms(16, None, owner="t")
    backend.sim.degrade_host(vms[3].host.host_id, slowdown=50.0)
    return _report(hb(vms, lambda: True), vms)


def _uniform(Backend, hb):
    backend = Backend(n_hosts=8)
    vms = backend.allocate_vms(4, None, owner="t")
    for vm in vms:
        backend.sim.degrade_host(vm.host.host_id, slowdown=5.0)
    return _report(hb(vms, lambda: True), vms)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 4096))
def test_tree_depth_equal(n):
    from repro.core.monitoring import tree_depth as J
    from repro_torch.core.monitoring import tree_depth as T
    assert T(n) == J(n)


@pytest.mark.parametrize("scenario,check", [
    (_rtts, lambda r: r[256][0] < 2.2 * r[16][0] and r[256][0] < 10 * r[1][0]),
    (_unreachable, lambda r: r[1] == [2] and not r[4]),
    (_unhealthy, lambda r: r[2] == [0] and not r[4]),
    (_straggler, lambda r: r[3] == [3] and r[4]),
    (_uniform, lambda r: r[3] == [] and r[4]),
], ids=["heartbeat_rtt", "unreachable", "unhealthy_hook", "straggler_zscore",
        "uniform_slowness"])
def test_heartbeat_reports_equal(scenario, check):
    ours, ref = _run("repro_torch", scenario), _run("repro", scenario)
    assert ours == ref
    assert check(ours)
