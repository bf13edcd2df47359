"""The reader of ``decode_graph_share.serve``: its value checked by hand on
a made-up tracer, nothing read where no capture was tried, and nothing
read from the small serving cell traced on the CPU, where the decode step
is never captured.

Run from the repository root: ``python -m pytest -q cacs_bench/tests``.
"""
from __future__ import annotations

import pytest

from cacs_bench import devtrace, harness

import bench_small
from test_cacs_bench_spans import _read, _run, _span, _tracer

METRIC = "decode_graph_share.serve"


def test_decode_graph_share_on_a_made_up_trace():
    """Five dispatch spans end in the window, three of them replays (the
    ``graph`` arg), one replay ends past it: 60 %. A program whose
    registry holds no capture outcome reads nothing; one whose capture
    fell back reads 0 where no span replayed."""
    from repro_torch.obs import use_tracer
    from repro_torch.obs.telemetry import MetricsRegistry, use_registry
    tr = _tracer()
    for i, graph in enumerate([1, 0, 1, 0, 1, 1]):
        args = {"graph": 1} if graph else {}
        _span(tr, "serve/dispatch", 100 + 200 * i, 150 + 200 * i, **args)
    run = _run()
    with use_tracer(tr):
        with use_registry(MetricsRegistry()):
            assert _read(METRIC, run) is None
        with use_registry(MetricsRegistry()) as reg:
            reg.inc("serve.decode_graph_captures")
            assert _read(METRIC, run) == pytest.approx(60.0)
            run.window = None
            assert _read(METRIC, run) is None
    tr = _tracer()
    _span(tr, "serve/dispatch", 100, 150)
    with use_tracer(tr), use_registry(MetricsRegistry()) as reg:
        reg.inc("serve.decode_graph_fallbacks", note="not captured")
        assert _read(METRIC, _run()) == 0.0


def test_small_serve_cell_on_the_cpu_reports_no_graph_share(monkeypatch):
    """The CPU never captures the decode step, so the traced small serving
    cell reports its host spans' metrics and leaves the share out."""
    monkeypatch.setattr(devtrace.DeviceWindow, "start", lambda self: None)
    res = harness.run_cell("jamba.serve", bench_small.SEED, 2.0, True,
                           require_chip=False, overrides=bench_small.serve())
    assert res["attempted"] > 0 and res["failed"] == 0
    got = res["metrics"]
    assert got["decode_dispatch_ms.serve"]["value"] > 0
    assert METRIC not in got
