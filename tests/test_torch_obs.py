"""The port's telemetry (``repro_torch.obs``): the cases of the JAX
package's ``tests/test_obs.py`` on the port's API — the metrics
registry, the span tracer, the checkpoint lifecycle's spans and
counters, the low-performance detector, the daemon error counters
through the port's app manager and replicator, the stall views of the
port's trainer and server, and deterministic trace export. The obs
modules are copies (the drift guard diffs them), but the trainer,
server, app manager, monitor and checkpoint path that feed them are the
port's own. Where both packages run a case, the same inputs go to both
and their readings (registry snapshots, span names, counters) are held
equal."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.obs as JO
from repro_torch.ckpt import InMemoryStore, restore, save_checkpoint
from repro_torch.ckpt.plane import ByteBudget
from repro_torch.obs import (MetricsRegistry, SampleView, Tracer,
                             use_registry, use_tracer)
from repro_torch.obs.telemetry import unique_name


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def port_clock():
    """The port's discrete-event virtual clock, installed for the test."""
    from repro_torch.sim import SimClock, install_clock
    clk = SimClock()
    prev = install_clock(clk)
    try:
        yield clk
    finally:
        clk.close()
        install_clock(prev)


def _both(fn):
    """``fn`` on the port's registry class and the reference's: both
    snapshots (the port's first), without their wall-clock stamps."""
    out = []
    for cls in (MetricsRegistry, JO.MetricsRegistry):
        reg = cls()
        fn(reg)
        out.append({k: {f: v for f, v in m.items() if f != "updated_at"}
                    for k, m in reg.snapshot().items()})
    return out


# ---------------------------------------------------------------------------
# registry primitives
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    reg.inc("c", 2)
    reg.inc("c")
    assert reg.value("c") == 3.0
    reg.set_gauge("g", 5.0)
    reg.set_gauge("g", 2.0)
    g = reg.gauge("g")
    assert g.value == 2.0 and g.high_water == 5.0
    reg.gauge_max("g", 9.0)                  # ratchets high-water only
    assert g.value == 2.0 and g.high_water == 9.0
    h = reg.histogram("h")
    for v in (0.001, 0.5, 100.0):
        h.observe(v)
    assert h.count == 3 and h.min == 0.001 and h.max == 100.0
    assert abs(h.sum - 100.501) < 1e-9

    def ops(r):
        r.inc("c", 2)
        r.set_gauge("g", 5.0)
        r.gauge_max("g", 9.0)
        for v in (0.001, 0.5, 100.0):
            r.histogram("h").observe(v)
    ours, theirs = _both(ops)
    assert ours == theirs


def test_registry_snapshot_sorted_and_typed():
    reg = MetricsRegistry()
    reg.inc("b.count")
    reg.set_gauge("a.level", 1.0)
    reg.histogram("c.lat").observe(0.2)
    snap = reg.snapshot()
    assert list(snap) == sorted(snap)
    assert snap["b.count"]["type"] == "counter"
    assert snap["a.level"]["type"] == "gauge"
    assert snap["c.lat"]["type"] == "histogram"
    assert reg.snapshot(prefix="a.").keys() == {"a.level"}
    ours, theirs = _both(lambda r: (r.inc("b.count"),
                                    r.set_gauge("a.level", 1.0),
                                    r.histogram("c.lat").observe(0.2)))
    assert ours == theirs


def test_metric_type_clash_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    with pytest.raises(TypeError):
        reg.histogram("x")


def test_disabled_registry_is_noop():
    reg = MetricsRegistry(enabled=False)
    reg.inc("c", 5)
    reg.set_gauge("g", 1.0)
    reg.histogram("h").observe(3.0)
    assert reg.value("c") == 0.0
    assert reg.gauge("g").value == 0.0
    assert reg.histogram("h").count == 0


def test_counter_note_keeps_last_error():
    reg = MetricsRegistry()
    reg.inc("errs", note="ValueError: first")
    reg.inc("errs", note="KeyError: second")
    c = reg.counter("errs")
    assert c.value == 2.0
    assert c.note == "KeyError: second"
    assert c.as_dict()["note"] == "KeyError: second"
    ours, theirs = _both(lambda r: (r.inc("errs", note="ValueError: first"),
                                    r.inc("errs", note="KeyError: second")))
    assert ours == theirs


def test_sample_view_is_list_like():
    reg = MetricsRegistry()
    h = reg.histogram(unique_name("view.test"))
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    view = SampleView(h)
    assert len(view) == 3
    assert view[0] == 0.1 and view[-1] == 0.3
    assert list(view) == [0.1, 0.2, 0.3]
    assert view == [0.1, 0.2, 0.3]
    with pytest.raises((TypeError, AttributeError)):
        view.append(0.4)                     # read-only: no list mutators


def test_trainer_and_serve_stalls_are_views():
    """The port's TrainerApp and ServeApp keep their capture stalls in a
    histogram and show them through a read-only view, as the reference's
    do; a live trainer's view reads its histogram."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.serve.engine import ServeApp
    from repro_torch.train.trainer import TrainerApp
    assert isinstance(TrainerApp.ckpt_stalls, property)
    assert isinstance(ServeApp.ckpt_stalls, property)
    cfg = dataclasses.replace(reduced(get_config("repro-100m")),
                              dtype="float32")
    app = TrainerApp(cfg, global_batch=2, seq_len=16, n_steps=2,
                     device="cpu")
    assert isinstance(app.ckpt_stalls, SampleView)
    assert list(app.ckpt_stalls) == []


# ---------------------------------------------------------------------------
# tracer primitives
# ---------------------------------------------------------------------------

def test_span_nesting_and_trace_id_inheritance():
    tr = Tracer()
    with tr.span("outer", cat="a", trace_id="tr-1") as outer:
        with tr.span("inner", cat="a") as inner:
            assert tr.current() is inner
        tr.event("ping")
        assert tr.current() is outer
    spans = {s.name: s for s in tr.spans()}
    assert spans["inner"].parent is spans["outer"]
    assert spans["inner"].trace_id == "tr-1"      # inherited
    assert spans["ping"].trace_id == "tr-1"
    assert spans["outer"].duration >= 0.0


def test_span_records_error_and_reraises():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    (sp,) = tr.spans(name="boom")
    assert sp.args["error"] == "ValueError"


def test_tracer_cap_counts_drops():
    tr = Tracer(max_records=3)
    for i in range(5):
        tr.event(f"e{i}")
    assert len(tr.spans()) == 3
    assert tr.dropped == 2


def test_tracer_cap_keeps_the_newest():
    """At its cap the tracer evicts the oldest records: a long-lived job
    keeps the spans an operator looks at."""
    tr = Tracer(max_records=3)
    for i in range(5):
        tr.event(f"e{i}")
    assert [s.name for s in tr.spans()] == ["e2", "e3", "e4"]


def test_wall_ns_brackets_the_span():
    """Under the wall clock a span's interval maps onto time.time_ns()'s
    epoch, inside the reads taken before and after it; again after a
    reset, which takes a new anchor."""
    tr = Tracer()
    for _ in range(2):
        before = time.time_ns()
        with tr.span("s") as sp:
            time.sleep(0.002)
        after = time.time_ns()
        t0, t1 = tr.wall_ns(sp)
        assert before <= t0 < t1 <= after
        assert t1 - t0 >= 2_000_000
        tr.reset()


def test_wall_ns_is_none_under_a_sim_clock(port_clock):
    tr = Tracer()
    with tr.span("s") as sp:
        port_clock.paper_sleep(1.0)
    assert sp.duration == pytest.approx(1.0)
    assert tr.wall_ns(sp) is None


def test_disabled_tracer_records_nothing():
    """A disabled tracer hands out inert spans and records no span and no
    event, the trainer's phases included."""
    from repro_torch.train.trainer import PhaseTimer
    tr = Tracer(enabled=False)
    timer = PhaseTimer("cpu")
    with use_tracer(tr):
        with tr.span("a", trace_id="t") as sp:
            sp.set("k", 1)
            tr.event("b")
        with timer.phase("train/forward"):
            pass
        timer.settle()
        _cpu_trainer(n_steps=1)
    assert tr.spans() == [] and tr.dropped == 0
    assert timer._pending == []


def test_exports_parse_and_correlate():
    tr = Tracer()
    with tr.span("save", cat="ckpt", trace_id="tr-9", args={"step": 1}):
        tr.event("upload", cat="ckpt")
    rows = [json.loads(ln) for ln in tr.to_jsonl().splitlines()]
    assert {r["name"] for r in rows} == {"save", "upload"}
    assert all(r["trace_id"] == "tr-9" for r in rows)
    by_name = {r["name"]: r for r in rows}
    assert by_name["upload"]["parent"] == by_name["save"]["id"]
    doc = json.loads(tr.to_chrome())
    names = [e["name"] for e in doc["traceEvents"]]
    assert "save" in names and "upload" in names and "thread_name" in names
    phases = {e["name"]: e["ph"] for e in doc["traceEvents"]}
    assert phases["upload"] == "i"               # instant event


# ---------------------------------------------------------------------------
# spans of the application and service layers
# ---------------------------------------------------------------------------

def _cfg():
    import dataclasses

    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("repro-100m")),
                               dtype="float32")


def _cpu_trainer(n_steps, trace_id="tr-app"):
    """A CPU TrainerApp started under a context carrying ``trace_id``,
    run to its end."""
    from repro_torch.core.application import AppContext
    from repro_torch.train.trainer import TrainerApp
    app = TrainerApp(_cfg(), global_batch=2, seq_len=16, n_steps=n_steps,
                     device="cpu")
    app.start(AppContext("c", [], trace_id=trace_id), None)
    app._thread.join(120)
    assert not app._thread.is_alive() and app.current_step == n_steps
    return app


def _children(tr, parent):
    return {s.name: s for s in tr.spans() if s.parent is parent}


def test_trainer_records_a_span_per_step_and_phase():
    """Each step is a ``train/step`` with the job's trace_id and its five
    phases as children; on the CPU no phase carries ``device_ms``."""
    with use_tracer(Tracer()) as tr:
        _cpu_trainer(n_steps=2)
    steps = tr.spans(name="train/step")
    assert [s.args["step"] for s in steps] == [0, 1]
    for st in steps:
        assert st.trace_id == "tr-app" and st.parent is None
        kids = _children(tr, st)
        assert set(kids) == {"train/batch", "train/forward",
                             "train/backward", "train/optimizer",
                             "train/sync"}
        assert all(k.trace_id == "tr-app" for k in kids.values())
        assert all("device_ms" not in k.args for k in kids.values())
        assert kids["train/forward"].t0 >= kids["train/batch"].t1
        assert kids["train/sync"].t0 >= kids["train/optimizer"].t1


def test_serve_records_a_span_per_token():
    """One ``serve/prefill``, then a ``serve/step`` per decoded token with
    its ``serve/dispatch`` and ``serve/token_wait``, all with the job's
    trace_id."""
    from repro_torch.core.application import AppContext
    from repro_torch.serve.engine import ServeApp
    with use_tracer(Tracer()) as tr:
        app = ServeApp(_cfg(), batch=2, prompt_len=8, n_tokens=5,
                       cache_len=16, device="cpu")
        app.start(AppContext("c", [], trace_id="tr-srv"), None)
        app._thread.join(120)
        assert not app._thread.is_alive() and app.generated == 5
    (pre,) = tr.spans(name="serve/prefill")
    assert pre.trace_id == "tr-srv"
    steps = tr.spans(name="serve/step")
    assert [s.args["pos"] for s in steps] == [8, 9, 10, 11]
    for st in steps:
        kids = _children(tr, st)
        assert set(kids) == {"serve/dispatch", "serve/token_wait"}
        assert all(s.trace_id == "tr-srv" for s in (st, *kids.values()))
        assert kids["serve/token_wait"].t0 >= kids["serve/dispatch"].t1
    assert len(tr.spans(name="serve/dispatch")) == 4


def test_a_failed_prefill_marks_the_server_unhealthy(monkeypatch):
    """A prefill that raises takes the decode failure's path: the job
    turns unhealthy, a waiter on its condition wakes, the failure is
    counted, and a capture raises instead of waiting on an empty cache."""
    from repro_torch.core.application import AppContext
    from repro_torch.serve import engine as E

    def fails(self, batch):
        raise ValueError("a prefill that fails")
    monkeypatch.setattr(E.Engine, "prefill", fails)
    with use_registry(MetricsRegistry()) as reg:
        app = E.ServeApp(_cfg(), batch=2, prompt_len=8, n_tokens=5,
                         cache_len=16, device="cpu")
        woke = threading.Event()

        def waiter():
            with app._cond:
                app._cond.wait_for(lambda: not app.healthy(), timeout=60)
            woke.set()
        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        app.start(AppContext("c", []), None)
        assert woke.wait(60)
        t.join(5)
        app._thread.join(60)
        assert not app._thread.is_alive()
        assert not app.healthy() and app.generated == 0
        assert reg.value("serve.decode_failures") == 1.0
        assert "ValueError" in reg.counter("serve.decode_failures").note
        with pytest.raises(RuntimeError):
            app.checkpoint_state()


def test_suspend_and_resume_spans_through_the_service():
    """A trainer suspended and resumed through CACSService: ``app/suspend``
    is the parent of the pin, the save (run on the writer thread), the
    stop (with the steps trained after the pin) and the cluster's
    teardown; ``app/resume`` of the new cluster, its provisioning, the
    restore and the start. All carry the job's trace_id."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import ASR, CACSService, CheckpointPolicy, CoordState
    from repro_torch.train.trainer import TrainerApp
    with use_tracer(Tracer()) as tr:
        svc = CACSService({"snooze": SnoozeBackend(4)},
                          {"default": InMemoryStore()})
        try:
            cid = svc.submit(ASR(
                name="train", n_vms=1, backend="snooze",
                app_factory=lambda: TrainerApp(_cfg(), global_batch=2,
                                               seq_len=16, n_steps=500,
                                               device="cpu"),
                policy=CheckpointPolicy(period_s=0)))
            svc.wait_for_state(cid, CoordState.RUNNING, 60)
            coord = svc.db.get(cid)

            def reach(k):
                deadline = time.monotonic() + 60
                while coord.app.current_step < k:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
            reach(1)
            svc.apps.suspend(cid)
            svc.apps.resume(cid)
            svc.wait_for_state(cid, CoordState.RUNNING, 60)
            reach(coord.app.current_step + 1)
            tid = coord.trace_id
        finally:
            svc.shutdown()
    assert tid
    (sus,) = tr.spans(name="app/suspend")
    kids = _children(tr, sus)
    assert {"ckpt/pin", "ckpt/save", "app/stop",
            "cloud/destroy"} <= set(kids)
    assert kids["app/stop"].args["work_lost"] >= 0
    assert kids["ckpt/save"].t0 >= kids["ckpt/pin"].t1
    (res,) = tr.spans(name="app/resume")
    kids = _children(tr, res)
    assert {"cloud/create", "provision", "ckpt/restore",
            "app/start"} <= set(kids)
    for sp in (sus, res, *kids.values()):
        assert sp.trace_id == tid
    steps = [s for s in tr.spans(name="train/step") if s.t0 >= res.t1]
    assert steps and all(s.trace_id == tid for s in steps)


def test_monitor_traces_only_unhealthy_polls():
    """Every poll is counted; only a report with unreachable hosts,
    failing health or stragglers is traced as ``monitor/poll``."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core.monitoring import MonitoringManager
    vms = SnoozeBackend(n_hosts=2).allocate_vms(2, None, owner="t")
    fired = []
    with use_registry(MetricsRegistry()) as reg, use_tracer(Tracer()) as tr:
        mon = MonitoringManager(lambda cid, kind: fired.append(kind))
        health = {"ok": True}
        mon.watch("c1", vms, lambda: health["ok"], True, trace_id="tr-mon")
        info = mon._watched["c1"]
        mon._poll_one("c1", info)
        assert reg.value("monitor.polls") == 1.0
        assert tr.spans(name="monitor/poll") == []
        health["ok"] = False
        mon._poll_one("c1", info)
        assert reg.value("monitor.polls") == 2.0
        (ev,) = tr.spans(name="monitor/poll")
        assert ev.trace_id == "tr-mon" and ev.args["ok"] is False
        assert fired == ["app_failure"]


# ---------------------------------------------------------------------------
# checkpoint-path instrumentation
# ---------------------------------------------------------------------------

def _np_tree():
    rng = np.random.Generator(np.random.PCG64(3))
    return {"w": rng.standard_normal(2048), "b": rng.standard_normal(64)}


def test_save_restore_spans_and_counters():
    """The port's save and restore emit the reference's spans and
    counters; the same tree through the reference counts the same."""
    names = ("ckpt/save", "ckpt/materialize", "ckpt/encode", "ckpt/upload",
             "ckpt/manifest", "ckpt/commit", "ckpt/restore", "restore/plan",
             "restore/fetch_decode", "restore/assemble")
    with use_registry(MetricsRegistry()) as reg, use_tracer(Tracer()) as tr:
        store = InMemoryStore()
        tree = {k: torch.from_numpy(v) for k, v in _np_tree().items()}
        save_checkpoint(store, "x", 1, tree, codec="zlib", trace_id="tr-sr")
        restore(store, "x", trace_id="tr-sr", device="cpu")
        for name in names:
            assert tr.spans(name=name, trace_id="tr-sr"), f"missing {name}"
        assert reg.value("ckpt.saves") == 1.0
        assert reg.value("ckpt.chunks") >= 2.0
        assert reg.value("ckpt.bytes_written") > 0.0
        ours = {k: reg.value(k) for k in ("ckpt.saves", "ckpt.chunks",
                                          "ckpt.bytes_written")}
    import repro.ckpt as J
    with JO.use_registry(JO.MetricsRegistry()) as jreg:
        J.save_checkpoint(J.InMemoryStore(), "x", 1, _np_tree(),
                          codec="zlib", trace_id="tr-sr")
        assert {k: jreg.value(k) for k in ours} == ours


def test_byte_budget_wait_and_high_water_metrics():
    with use_registry(MetricsRegistry()) as reg:
        budget = ByteBudget(100, name="tb")
        budget.acquire(80)
        blocked = threading.Event()

        def late():
            budget.acquire(50)               # must wait for the release
            blocked.set()

        t = threading.Thread(target=late, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not blocked.is_set()
        budget.release(80)
        assert blocked.wait(5.0)
        t.join(5.0)
        assert reg.histogram("tb.budget_wait_s").count == 1
        assert reg.gauge("tb.inflight_bytes").high_water == 80.0


# ---------------------------------------------------------------------------
# low-performance detection + daemon error counters
# ---------------------------------------------------------------------------

def test_lowperf_detector_fires_after_grace(port_clock):
    from repro_torch.core.monitoring import LowPerfConfig, MonitoringManager
    from repro_torch.sim import active_clock
    with use_registry(MetricsRegistry()) as reg:
        mon = MonitoringManager(
            lambda cid, kind: None,
            lowperf=LowPerfConfig(warmup_samples=2, grace_polls=2,
                                  min_window_s=0.5))
        counter = {"v": 0.0}
        mon.watch("c1", [], None, False, perf_fn=lambda: counter["v"],
                  trace_id="tr-perf")
        info = mon._watched["c1"]
        clk = active_clock()

        def sample(rate):
            counter["v"] += rate             # 1 paper-second window
            clk.paper_sleep(1.0)
            return mon._check_perf("c1", info)

        assert not sample(2.0)               # warmup 1
        assert not sample(2.0)               # warmup 2 -> baseline 2.0
        assert info["perf_baseline"] == pytest.approx(2.0)
        fired = [sample(0.05) for _ in range(8)]
        assert any(fired), "EWMA collapse under 0.4x baseline must fire"
        assert fired.count(True) == 1        # exactly once per watch
        assert not sample(0.05)              # stays fired
        assert reg.value("app.throughput:c1", -1) >= 0.0
        assert reg.gauge("app.throughput_ewma:c1").value < 0.8


def test_lowperf_healthy_app_never_fires(port_clock):
    from repro_torch.core.monitoring import LowPerfConfig, MonitoringManager
    from repro_torch.sim import active_clock
    with use_registry(MetricsRegistry()):
        mon = MonitoringManager(
            lambda cid, kind: None,
            lowperf=LowPerfConfig(warmup_samples=2, grace_polls=2,
                                  min_window_s=0.5))
        counter = {"v": 0.0}
        mon.watch("c2", [], None, False, perf_fn=lambda: counter["v"])
        info = mon._watched["c2"]
        clk = active_clock()
        for _ in range(12):                  # steady pace
            counter["v"] += 2.0
            clk.paper_sleep(1.0)
            assert not mon._check_perf("c2", info)


def test_appmgr_guarded_errors_counted():
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core.service import CACSService
    with use_registry(MetricsRegistry()) as reg:
        backend = SnoozeBackend(n_hosts=2)
        svc = CACSService({backend.name: backend}, start_daemons=False)
        try:
            svc.apps._guarded(lambda: 1 / 0)
        finally:
            svc.shutdown()
        assert reg.value("appmgr.op_errors") == 1.0
        assert "ZeroDivisionError" in reg.counter("appmgr.op_errors").note


def test_ckpt_daemon_error_counted():
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core.application import SimulatedApp
    from repro_torch.core.coordinator import ASR, CheckpointPolicy, CoordState
    from repro_torch.core.service import CACSService
    with use_registry(MetricsRegistry()) as reg:
        backend = SnoozeBackend(n_hosts=2)
        svc = CACSService({backend.name: backend})
        asr = ASR(name="dmn", n_vms=1, backend=backend.name,
                  app_factory=lambda: SimulatedApp(iter_time_s=0.05,
                                                   state_mb=0.01),
                  policy=CheckpointPolicy(period_s=0.05))
        cid = svc.submit(asr)
        try:
            svc.wait_for_state(cid, CoordState.RUNNING, timeout=30)

            def boom(*a, **kw):
                raise RuntimeError("daemon boom")

            svc.apps.checkpoint_now = boom   # periodic save now explodes
            deadline = time.monotonic() + 10
            while (reg.value("appmgr.daemon_errors") == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            del svc.apps.checkpoint_now      # terminate needs the real one
            svc.shutdown()
        assert reg.value("appmgr.daemon_errors") >= 1.0
        note = reg.counter("appmgr.daemon_errors").note
        assert "RuntimeError: daemon boom" in note


def test_replication_daemon_error_counted():
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core.application import SimulatedApp
    from repro_torch.core.coordinator import ASR, CheckpointPolicy, CoordState
    from repro_torch.core.replication import (ImageReplicator,
                                              ReplicationPolicy,
                                              StandbyTarget)
    from repro_torch.core.service import CACSService
    with use_registry(MetricsRegistry()) as reg:
        backend = SnoozeBackend(n_hosts=2)
        svc = CACSService({backend.name: backend}, start_daemons=False)
        asr = ASR(name="rep", n_vms=1, backend=backend.name,
                  app_factory=lambda: SimulatedApp(iter_time_s=0.05,
                                                   state_mb=0.01),
                  policy=CheckpointPolicy(period_s=0.0))
        cid = svc.submit(asr)
        try:
            svc.wait_for_state(cid, CoordState.RUNNING, timeout=30)
            rep = ImageReplicator(svc)
            rep.add_target(StandbyTarget("dr", InMemoryStore(), "cloud"))
            rep.watch(cid, ReplicationPolicy(targets=("dr",)))

            def boom(*a, **kw):
                raise OSError("standby store down")

            rep._sync_pair = boom            # the swallowed-except path
            rep.sync()
        finally:
            svc.shutdown()
        assert reg.value("replication.daemon_errors") == 1.0
        note = reg.counter("replication.daemon_errors").note
        assert "OSError: standby store down" in note
        assert rep.sync_errors == 1


# ---------------------------------------------------------------------------
# deterministic export (same discipline as the SimEngine trace digests)
# ---------------------------------------------------------------------------

_DET_SNIPPET = """
import sys
sys.path.insert(0, {src!r})
import hashlib
import numpy as np
from {pkg}.ckpt import DataPlaneConfig, InMemoryStore, restore, \\
    save_checkpoint
from {pkg}.obs import MetricsRegistry, Tracer, use_registry, use_tracer
from {pkg}.sim import SimClock, use_clock
kw = {kw}


def run_once():
    clk = SimClock()
    try:
        with use_clock(clk), use_registry(MetricsRegistry()) as reg, \\
                use_tracer(Tracer()) as tr:
            rng = np.random.Generator(np.random.PCG64(7))
            tree = {{"a": rng.standard_normal(512),
                     "nest": {{"b": rng.standard_normal(256)}}}}
            store = InMemoryStore()
            plane = DataPlaneConfig.serial()
            save_checkpoint(store, "x", 1, tree, codec="zlib", plane=plane,
                            trace_id="tr-det-0000")
            restore(store, "x", plane=plane, trace_id="tr-det-0000", **kw)
            snap = repr(sorted(reg.snapshot().items()))
            names = sorted({{s.name for s in tr.spans()}})
            return tr.to_jsonl(), tr.to_chrome(), snap, names
    finally:
        clk.close()


a, b = run_once(), run_once()
assert a[0] == b[0], "JSONL export diverged across replays"
assert a[1] == b[1], "Chrome export diverged across replays"
assert a[2] == b[2], "registry snapshot diverged across replays"
print(hashlib.sha256("".join(a[:3]).encode()).hexdigest())
print(" ".join(a[3]))
"""


def _run_det(hashseed: str, pkg: str = "repro_torch") -> str:
    src = os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    r = subprocess.run(
        [sys.executable, "-c", _DET_SNIPPET.format(src=src, pkg=pkg, kw=kw)],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, f"determinism subprocess failed:\n{r.stderr}"
    return r.stdout


def test_trace_export_deterministic_across_processes():
    """Same seed => byte-identical JSONL + Chrome exports, within a
    process (assert inside the snippet) AND across processes with
    different hash seeds; the port's replay emits the reference's span
    names."""
    ours = _run_det("0")
    assert ours == _run_det("1")
    assert ours.splitlines()[1] == _run_det("0", "repro").splitlines()[1]
