"""The readers of the port's program spans: each one's value checked by
hand on a made-up tracer and device window, nothing read where its spans
or device times are absent, and both small cells run traced on the CPU.

Run from the repository root: ``python -m pytest -q cacs_bench/tests``.
"""
from __future__ import annotations

import pytest

from cacs_bench import devtrace, harness

import bench_small

SERVE = ("decode_dispatch_ms.serve", "decode_wait_ms.serve",
         "token_gap_p95_ms.serve", "idle_dispatch_share.serve")
TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
         "suspend_stop_s.swap", "steps_lost.swap")
MS = 1_000_000                          # ns


def _tracer():
    """A tracer whose wall anchor is the epoch's zero, so a span stamped
    at paper time ``ms / 10`` sits at ``ms`` ms (the wall clock's 0.01 s
    a paper second)."""
    from repro_torch.obs import Tracer
    tr = Tracer()
    tr._anchor = (0, 0)
    return tr


def _span(tr, name, t0_ms, t1_ms, parent=None, **args):
    from repro_torch.obs.trace import Span
    sp = Span(name, "test", "tr-b", t0_ms / 10, args or None, parent)
    sp.t1 = t1_ms / 10
    tr._record(sp)
    return sp


def _run(events=()):
    w = devtrace.DeviceWindow(False)
    w.t_open, w.t_close = 0, 1000 * MS
    w.events = [("k", s * MS, e * MS) for s, e in events]
    return harness.Run(data={}, checks=[], attempted=0, failed=0,
                       memory_peak_bytes=0, window=w)


def _read(name, run):
    return harness.reader(name).read(run)


def test_serve_readers_on_a_made_up_trace():
    """Four decode steps in the window and one on either side of it. The
    card idles over [70, 90] ms, half of it inside the dispatch over [60,
    80], and over [120, 185], 10 ms of it inside the dispatch over [105,
    130] and 30 inside [150, 180]: 50 of 85 idle ms."""
    from repro_torch.obs import use_tracer
    tr = _tracer()
    _span(tr, "serve/step", -50, -10)
    _span(tr, "serve/dispatch", -50, -30)
    for (s0, s1), (d0, d1), (w0, w1) in [
            ((55, 100), (60, 80), (82, 88)),
            ((100, 140), (105, 130), (132, 139)),
            ((140, 190), (150, 180), (182, 188)),
            ((190, 250), (200, 240), (242, 249)),
            ((990, 1100), (1010, 1050), (1052, 1060))]:
        st = _span(tr, "serve/step", s0, s1, pos=s0)
        _span(tr, "serve/dispatch", d0, d1, parent=st)
        _span(tr, "serve/token_wait", w0, w1, parent=st)
    run = _run([(0, 70), (90, 120), (185, 1000)])
    with use_tracer(tr):
        assert _read("decode_dispatch_ms.serve", run) == pytest.approx(27.5)
        assert _read("decode_wait_ms.serve", run) == pytest.approx(6.5)
        # gaps 40, 50, 60 ms between the ends: the 95th percentile 59
        assert _read("token_gap_p95_ms.serve", run) == pytest.approx(59.0)
        assert _read("idle_dispatch_share.serve", run) == \
            pytest.approx(100.0 * 50 / 85)
        assert _read("idle_dispatch_share.serve", _run()) is None
        run.window = None
        assert all(_read(m, run) is None for m in SERVE)


def test_train_readers_on_a_made_up_trace():
    """The window's suspend and resume, then steps: the one before the
    resume ends and the one past the close are left out of the medians."""
    from repro_torch.obs import use_tracer
    tr = _tracer()
    sus = _span(tr, "app/suspend", 0, 9)
    _span(tr, "app/stop", 5.5, 8, parent=sus, work_lost=3.0)
    _span(tr, "app/resume", 10, 300)
    for (t0, t1), dev in [((0, 200), (999, 999, 999)),
                          ((300, 500), (50, 100, 10)),
                          ((500, 700), (60, 130, 20)),
                          ((700, 950), (70, 120, 15)),
                          ((950, 1100), (999, 999, 999))]:
        st = _span(tr, "train/step", t0, t1)
        for name, ms in zip(("forward", "backward", "optimizer"), dev):
            _span(tr, "train/" + name, t0 + 1, t0 + 2, parent=st,
                  device_ms=ms)
    _span(tr, "train/forward", 800, 810, device_ms=999.0)   # no step
    run = _run()
    with use_tracer(tr):
        assert _read("forward_ms.train", run) == 60
        assert _read("backward_ms.train", run) == 120
        assert _read("optimizer_ms.train", run) == 15
        assert _read("suspend_stop_s.swap", run) == pytest.approx(2.5e-3)
        assert _read("steps_lost.swap", run) == 3.0
        for sp in tr.spans():
            sp.args.pop("device_ms", None)
            sp.args.pop("work_lost", None)
        assert _read("forward_ms.train", run) is None
        assert _read("steps_lost.swap", run) is None
    with use_tracer(_tracer()):
        assert all(_read(m, run) is None for m in TRAIN)


def test_readers_read_nothing_off_the_wall_clock():
    """Under a virtual clock the tracer cannot place its spans on the
    device trace's epoch: the readers read nothing."""
    from repro_torch.obs import use_tracer
    from repro_torch.sim import SimClock, use_clock
    tr = _tracer()
    _span(tr, "serve/dispatch", 10, 20)
    clk = SimClock()
    try:
        with use_clock(clk), use_tracer(tr):
            assert _read("decode_dispatch_ms.serve",
                         _run([(0, 5)])) is None
    finally:
        clk.close()


@pytest.mark.parametrize("cell,small,host,none", [
    ("internlm2.swap", bench_small.train,
     ("suspend_stop_s.swap", "steps_lost.swap"),
     ("forward_ms.train", "backward_ms.train", "optimizer_ms.train")),
    ("jamba.serve", bench_small.serve,
     ("decode_dispatch_ms.serve", "decode_wait_ms.serve",
      "token_gap_p95_ms.serve"),
     ("idle_dispatch_share.serve",))])
def test_small_cells_traced_on_the_cpu(cell, small, host, none, monkeypatch):
    """Traced on the CPU, where the profiler has no device to trace (its
    window stays empty), the host spans' metrics report values and those
    of device times report nothing."""
    monkeypatch.setattr(devtrace.DeviceWindow, "start", lambda self: None)
    res = harness.run_cell(cell, bench_small.SEED, 2.0, True,
                           require_chip=False, overrides=small())
    assert res["attempted"] > 0 and res["failed"] == 0
    got = res["metrics"]
    for m in host:
        assert got[m]["value"] >= 0, m
    assert got[host[0]]["value"] > 0
    for m in none:
        assert m not in got, m
