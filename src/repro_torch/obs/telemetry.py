"""Unified virtual-time metrics registry (counters / gauges / histograms).

Every layer of the service (ckpt writer and reader, data-plane budget,
scheduler, gang barrier, replication, monitoring, apps) publishes into one
process-wide ``MetricsRegistry`` instead of growing its own ad-hoc stats
dict.  Three properties make it fit this repo:

  * **paper-second stamps** — every update is stamped from
    ``sim.simtime.active_clock()`` and normalized by ``clock.scale``, so a
    snapshot taken under ``SimClock`` reads in paper seconds and is
    bit-for-bit replayable (same seed, same schedule => same snapshot).
  * **deterministic shape** — histograms use *fixed* bucket edges chosen at
    creation (never rebalanced), and ``snapshot()`` emits keys in sorted
    order, so serialized snapshots are stable across runs and
    ``PYTHONHASHSEED`` values.
  * **cheap when off** — every mutator checks ``enabled`` first; the
    disabled path is one attribute load and a branch (guarded by the
    ``obs`` overhead benchmark at < 5% on the ckpt path).

The module-level ``registry()`` / ``install_registry()`` /
``use_registry()`` API mirrors ``sim.simtime.active_clock()`` so tests can
swap in a fresh registry for isolation.
"""
from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.sim.simtime import active_clock

__all__ = [
    "Counter", "Gauge", "Histogram", "SampleView", "MetricsRegistry",
    "registry", "install_registry", "use_registry", "paper_now",
    "DEFAULT_EDGES",
]

# Fixed default bucket edges (paper seconds).  Spanning 100µs..5min covers
# everything we time: per-chunk encode/upload (sub-ms..ms), budget waits,
# snapshot stalls (µs..ms), and whole save/restore cycles (s..min).
DEFAULT_EDGES: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)


def paper_now() -> float:
    """Current time of the installed clock, in paper seconds."""
    clk = active_clock()
    return clk.now() / clk.scale


class Counter:
    """Monotonic-by-convention counter with an optional last-error note.

    ``value`` is settable (``counter.value = 0``) so registry-backed
    attribute views (e.g. ``GlobalScheduler.preemptions``) keep supporting
    plain ``+=`` / ``= 0`` assignment.
    """

    __slots__ = ("name", "_value", "note", "updated_at", "_reg")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._value = 0.0
        self.note = ""                 # last-error string (daemon counters)
        self.updated_at = 0.0
        self._reg = reg

    def inc(self, n: float = 1.0, note: Optional[str] = None) -> None:
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self._value += n
            if note is not None:
                self.note = note
            self.updated_at = paper_now()

    @property
    def value(self) -> float:
        return self._value

    @value.setter
    def value(self, v: float) -> None:
        with self._reg._lock:
            self._value = float(v)
            self.updated_at = paper_now()

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": "counter", "value": self._value,
                             "updated_at": self.updated_at}
        if self.note:
            d["note"] = self.note
        return d


class Gauge:
    """Last-value gauge with an optional high-water mark (``set_max``)."""

    __slots__ = ("name", "value", "high_water", "updated_at", "_reg")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self.value = 0.0
        self.high_water = 0.0
        self.updated_at = 0.0
        self._reg = reg

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self.value = v
            if v > self.high_water:
                self.high_water = v
            self.updated_at = paper_now()

    def set_max(self, v: float) -> None:
        """Ratchet the high-water mark without disturbing ``value``."""
        if not self._reg.enabled:
            return
        with self._reg._lock:
            if v > self.high_water:
                self.high_water = v
                self.updated_at = paper_now()

    def as_dict(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value,
                "high_water": self.high_water, "updated_at": self.updated_at}


class Histogram:
    """Fixed-edge histogram that also retains raw samples.

    Edges are frozen at creation (``DEFAULT_EDGES`` unless given), so two
    runs of the same schedule bucket identically — no dynamic rebalancing,
    no run-order dependence.  Raw samples are retained (they are what
    backward-compat views like ``TrainerApp.ckpt_stalls`` expose), capped
    at ``max_samples`` oldest-first so a long-lived daemon cannot grow one
    unboundedly.
    """

    __slots__ = ("name", "edges", "bucket_counts", "count", "sum", "min",
                 "max", "samples", "max_samples", "updated_at", "_reg")

    def __init__(self, name: str, reg: "MetricsRegistry",
                 edges: Optional[Sequence[float]] = None,
                 max_samples: int = 4096):
        self.name = name
        self.edges: Tuple[float, ...] = tuple(edges or DEFAULT_EDGES)
        self.bucket_counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []
        self.max_samples = max_samples
        self.updated_at = 0.0
        self._reg = reg

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._reg._lock:
            i = 0
            for edge in self.edges:
                if v <= edge:
                    break
                i += 1
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self.samples) < self.max_samples:
                self.samples.append(v)
            self.updated_at = paper_now()

    def as_dict(self) -> Dict[str, Any]:
        return {
            "type": "histogram", "edges": list(self.edges),
            "bucket_counts": list(self.bucket_counts), "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "updated_at": self.updated_at,
        }


class SampleView(Sequence):
    """Read-only sequence view over a histogram's retained samples.

    Backward-compat shim for attributes that used to be bare lists
    (``TrainerApp.ckpt_stalls``): supports ``len``, indexing, slicing and
    iteration, but not mutation — the histogram is the source of truth.
    """

    __slots__ = ("_hist",)

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __len__(self) -> int:
        return len(self._hist.samples)

    def __getitem__(self, i):
        return self._hist.samples[i]

    def __iter__(self) -> Iterator[float]:
        return iter(list(self._hist.samples))

    def __repr__(self) -> str:
        return f"SampleView({self._hist.samples!r})"

    def __eq__(self, other) -> bool:
        return list(self) == list(other)


class MetricsRegistry:
    """Thread-safe named-metric registry.

    One instance is process-global by default (see ``registry()``); all
    instruments created from it share its ``enabled`` switch and lock.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: Dict[str, Any] = {}

    # -- instrument factories (get-or-create, idempotent) -----------------
    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, self, edges=edges)
                self._metrics[name] = m
            elif not isinstance(m, Histogram):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}")
            return m

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}")
            return m

    # -- one-shot conveniences --------------------------------------------
    def inc(self, name: str, n: float = 1.0,
            note: Optional[str] = None) -> None:
        if self.enabled:
            self.counter(name).inc(n, note)

    def set_gauge(self, name: str, v: float) -> None:
        if self.enabled:
            self.gauge(name).set(v)

    def gauge_max(self, name: str, v: float) -> None:
        if self.enabled:
            self.gauge(name).set_max(v)

    def observe(self, name: str, v: float,
                edges: Optional[Sequence[float]] = None) -> None:
        if self.enabled:
            self.histogram(name, edges=edges).observe(v)

    # -- inspection ---------------------------------------------------------
    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default: float = 0.0) -> float:
        m = self.get(name)
        if m is None:
            return default
        return m.value if not isinstance(m, Histogram) else m.count

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self, prefix: str = "") -> Dict[str, Dict[str, Any]]:
        """Deterministic dict of every metric (sorted keys), optionally
        filtered by name prefix.  Timestamps are paper seconds."""
        with self._lock:
            return {name: m.as_dict()
                    for name, m in sorted(self._metrics.items())
                    if name.startswith(prefix)}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# Process-global registry, mirroring sim.simtime's active-clock idiom.
# ---------------------------------------------------------------------------
_REGISTRY = MetricsRegistry()
_REG_LOCK = threading.Lock()

# Monotonic suffix source for per-instance metric names (one histogram per
# TrainerApp etc. — deterministic by construction order, never hash order).
_SEQ = itertools.count(1)


def unique_name(base: str) -> str:
    """``base#N`` with a process-monotonic N — per-instance metric names."""
    return f"{base}#{next(_SEQ)}"


def registry() -> MetricsRegistry:
    return _REGISTRY


def install_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    with _REG_LOCK:
        prev, _REGISTRY = _REGISTRY, reg
    return prev


@contextmanager
def use_registry(reg: Optional[MetricsRegistry] = None):
    """Temporarily install ``reg`` (a fresh registry when None)."""
    reg = reg if reg is not None else MetricsRegistry()
    prev = install_registry(reg)
    try:
        yield reg
    finally:
        install_registry(prev)
