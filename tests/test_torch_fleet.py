"""The port's serving fleet against the reference's.

A ``FleetController`` over the port's ``GlobalScheduler`` manages reduced
f32 ``ServeApp`` replicas on the CPU. The seed image is the state of a
reference (JAX) ``ServeApp`` after a few tokens, handed over through
``repro_torch.convert``; the reference's fleet publishes the same state.
Replicas cold-start from the seed by prefix adoption with zero chunk
re-uploads, and their token streams equal the reference ``ServeApp``'s
uninterrupted stream. A replica parked by scale-in mid-generation hands
its host to batch work, comes back by scale-out and still ends with the
reference's tokens. The reference fleet, driven the same way, gives the
same decision trace and the same fleet counters.
"""
import dataclasses
import importlib
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.serve.engine import ServeApp as JServeApp
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import serve_state_from_jax
from repro_torch.obs.telemetry import registry
from repro_torch.serve.engine import ServeApp
from repro_torch.tree import tree_leaves

JCFG = dataclasses.replace(reduced(get_config("repro-100m")), dtype="float32")
CFG = dataclasses.replace(treduced(tget_config("repro-100m")),
                          dtype="float32")
SEED_TOKENS, N_TOKENS = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(n_tokens):
    app = JServeApp(JCFG, batch=1, prompt_len=8, n_tokens=n_tokens,
                    cache_len=48)
    app.start(None, None)
    deadline = time.monotonic() + 120
    while not app.is_done():
        assert time.monotonic() < deadline, "reference serving stalled"
        time.sleep(0.01)
    app.stop()
    return jax.device_get(app.checkpoint_state())


@pytest.fixture(scope="module")
def streams():
    """The reference's seed state and its uninterrupted stream."""
    seed = _jax_run(SEED_TOKENS)
    want = _jax_run(N_TOKENS)["tokens_out"]
    np.testing.assert_array_equal(want[:, :SEED_TOKENS], seed["tokens_out"])
    return seed, want


def _package(root, seed_state):
    core = importlib.import_module(f"{root}.core")
    serve = importlib.import_module(f"{root}.serve")
    sim = importlib.import_module(f"{root}.sim")
    if root == "repro":
        factory = lambda: JServeApp(JCFG, batch=1, prompt_len=8,   # noqa
                                    n_tokens=N_TOKENS, cache_len=48,
                                    token_delay_s=0.01)
        state = seed_state
    else:
        factory = lambda: ServeApp(CFG, batch=1, prompt_len=8,     # noqa
                                   n_tokens=N_TOKENS, cache_len=48,
                                   token_delay_s=0.01, device="cpu")
        state = serve_state_from_jax(seed_state, "cpu")
    return types.SimpleNamespace(
        core=core, serve=serve, sim=sim, factory=factory, state=state,
        SnoozeBackend=importlib.import_module(f"{root}.clusters")
        .SnoozeBackend,
        InMemoryStore=importlib.import_module(f"{root}.ckpt").InMemoryStore,
        list_steps=importlib.import_module(f"{root}.ckpt.reader").list_steps)


def _until(P, cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        P.sim.active_clock().sleep(0.01)


def _fleet_run(P):
    """Scale out two replicas from the seed, park one mid-generation for a
    batch job, unpark it (preempting the batch job back), run both to the
    end. Returns what the comparison needs."""
    c = P.core
    store = P.InMemoryStore()
    svc = c.CACSService({"snooze": P.SnoozeBackend(n_hosts=4)},
                        {"default": store})
    sched = c.GlobalScheduler(svc)
    svc.attach_scheduler(sched)
    fleet = P.serve.FleetController(
        svc, sched, name="m1", replica_factory=P.factory,
        policy=P.serve.FleetPolicy(min_replicas=1, max_replicas=4,
                                   scale_in_idle_s=0.0),
        backend="snooze", priority=5)
    out = {}
    try:
        fleet.publish_seed(P.state, step=SEED_TOKENS)
        puts = store.put_count
        cids = fleet.scale_out(2)
        fleet.wait_live(cids, timeout=60)
        out["coldstart_puts"] = store.put_count - puts
        out["own_steps"] = [P.list_steps(store, svc.db.get(cid).ckpt_prefix)
                            for cid in cids]
        out["restarts"] = [svc.db.get(cid).app.restarts for cid in cids]
        first = svc.db.get(cids[0]).app
        if isinstance(first, ServeApp):          # the port's leaves
            out["devices"] = sorted({
                t.device.type for t in tree_leaves(
                    first.checkpoint_state()["params"])})
        batch = sched.submit(c.ASR(
            name="batch", n_vms=3, backend="snooze", priority=1,
            app_factory=lambda: c.SimulatedApp(iter_time_s=0.5,
                                               state_mb=0.01),
            policy=c.CheckpointPolicy(period_s=0)))
        out["batch_queued"] = svc.db.get(batch).state.value
        app = svc.db.get(cids[0]).app
        _until(P, lambda: app.generated >= SEED_TOKENS + 2, "two tokens")
        parked = fleet.scale_in(1, force=True)
        coord = svc.db.get(parked[0])
        out["parked_at"] = (coord.state.value, coord.app.generated
                            < N_TOKENS)
        sched.tick()
        svc.wait_for_state(batch, c.CoordState.RUNNING, 30)
        out["parked_held"] = svc.db.get(parked[0]).state.value
        out["unparked"] = fleet.scale_out(1) == parked
        fleet.wait_live(parked, timeout=60)
        out["batch_after"] = svc.db.get(batch).state.value
        tokens = {}
        for cid in cids:
            a = svc.db.get(cid).app
            _until(P, a.is_done, "replica done")
            tokens[svc.db.get(cid).asr.name] = np.asarray(
                a.checkpoint_state()["tokens_out"])
        out["tokens"] = tokens
        out["restarts_end"] = [svc.db.get(cid).app.restarts for cid in cids]
        out["stats"] = fleet.stats()
        out["decisions"] = [t[1:] for t in sched.decision_trace()]
        return out
    finally:
        sched.stop()
        svc.shutdown()


def _on_own_clock(P):
    clk = P.sim.SimClock()
    prev = P.sim.install_clock(clk)
    try:
        return _fleet_run(P)
    finally:
        clk.close()
        P.sim.install_clock(prev)


def test_fleet_cold_starts_parks_and_unparks_like_the_reference(streams):
    seed, want = streams
    ref = _on_own_clock(_package("repro", seed))
    ours = _on_own_clock(_package("repro_torch", seed))
    # cold start: the seed restored by adoption, nothing written
    assert ours["coldstart_puts"] == ref["coldstart_puts"] == 0
    assert ours["own_steps"] == [[], []]
    assert ours["restarts"] == [1, 1] and ours["devices"] == ["cpu"]
    assert ours["stats"]["coldstart_reuploads"] == 0
    # park: the batch job gets the host; unpark preempts it back
    assert ours["batch_queued"] == "QUEUED"
    assert ours["parked_at"] == ("SUSPENDED", True)
    assert ours["parked_held"] == "SUSPENDED"
    assert ours["unparked"] and ours["batch_after"] == "SUSPENDED"
    assert ours["restarts_end"] == [2, 1]
    # the reference's tokens, and the reference fleet's bookkeeping
    assert sorted(ours["tokens"]) == ["m1-r000", "m1-r001"]
    for name, got in ours["tokens"].items():
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ref["tokens"][name], want)
    for key in ("stats", "decisions", "parked_at", "parked_held",
                "batch_after", "restarts", "restarts_end"):
        assert ours[key] == ref[key], key
    assert ours["stats"]["parks"] == ours["stats"]["unparks"] == 1
    assert registry().value("fleet.m1.parks", 0.0) >= 1


def test_replica_cold_start_is_a_registry_metric(streams):
    """The cold-start latency lands in the registry under the replica's
    trace_id, and the replica's restored state is on the CPU it declares."""
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import CACSService, CoordState, GlobalScheduler
    from repro_torch.serve import FleetController, FleetPolicy
    from repro_torch.sim import SimClock, install_clock
    seed, want = streams
    clk = SimClock()
    prev = install_clock(clk)
    svc = CACSService({"snooze": SnoozeBackend(n_hosts=2)},
                      {"default": InMemoryStore()})
    sched = GlobalScheduler(svc)
    try:
        fleet = FleetController(
            svc, sched, name="m2",
            replica_factory=lambda: ServeApp(
                CFG, batch=1, prompt_len=8, n_tokens=N_TOKENS, cache_len=48,
                device="cpu"),
            seed_prefix="fleet/m2/seed", policy=FleetPolicy(max_replicas=2))
        fleet.publish_seed(serve_state_from_jax(seed, "cpu"),
                           step=SEED_TOKENS)
        (cid,) = fleet.scale_out(1)
        fleet.wait_live([cid], timeout=60)
        coord = svc.db.get(cid)
        assert coord.state == CoordState.RUNNING
        assert coord.ckpt_adopt_prefix == "fleet/m2/seed"
        assert coord.metrics["coldstart_s"] >= 0.0
        gauge = registry().value(f"coord.{coord.trace_id}.coldstart_s", None)
        assert gauge is not None and gauge >= 0.0
        assert fleet.route() == cid and fleet.router.outstanding(cid) == 1
        fleet.complete(cid)
        assert fleet.router.outstanding() == 0
        deadline = time.monotonic() + 60
        while not coord.app.is_done():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        np.testing.assert_array_equal(
            coord.app.checkpoint_state()["tokens_out"], want)
        assert fleet.stats()["coldstarts"] == 1
    finally:
        sched.stop()
        svc.shutdown()
        clk.close()
        install_clock(prev)
