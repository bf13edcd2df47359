"""Unified observability layer: metrics registry + span tracing.

See ``telemetry.py`` (counters/gauges/histograms in paper seconds) and
``trace.py`` (trace_id-correlated spans with JSONL / Chrome exporters).
"""
from repro_torch.obs.telemetry import (MetricsRegistry, SampleView,   # noqa: F401
                                 install_registry, registry, use_registry)
from repro_torch.obs.trace import (Tracer, install_tracer, tracer,    # noqa: F401
                             use_tracer)
