"""Cross-layer span tracing on the virtual clock.

A ``Span`` is a named interval stamped in paper seconds from
``sim.simtime.active_clock()``, carrying the per-job ``trace_id`` (PR 7's
coordinator id-stamp) so one job's checkpoint saves, scheduler decisions,
gang barrier phases, replication ships and monitor detections all
correlate in a single timeline.  ``Tracer.span`` is a context manager;
nesting on one thread is automatic (thread-local stack), and work handed
to pool threads passes ``parent=`` explicitly (the writer/reader pipelines
do this for per-chunk encode/upload/fetch spans).

Exports:

  * ``export_jsonl`` — one JSON object per line, self-contained.
  * ``export_chrome`` — Chrome trace-event JSON; open in Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing``.  One ``tid`` per
    ``trace_id`` so each job reads as its own track.

Both exporters are **canonical**: records are sorted by
``(trace_id, t0, t1, cat, name, args)`` and span ids renumbered in that
order, so two runs of the same virtual-time schedule serialize
byte-for-byte identically regardless of thread interleaving or
``PYTHONHASHSEED`` (the same discipline as ``SimEngine`` traces — and with
the same caveat: only schedules whose *timestamps* are deterministic, e.g.
a serial data plane under ``SimClock``, yield identical bytes; parallel
planes replay identical span *sets* with jittered stamps).

The module-level ``tracer()`` / ``install_tracer()`` / ``use_tracer()``
API mirrors ``sim.simtime.active_clock()``.

Under the ``WallClock`` a span's paper stamps are ``time.monotonic()``
scaled; ``Tracer.wall_ns`` maps them onto ``time.time_ns()``'s epoch
through an anchor pair the tracer takes when it is made and at
``reset()``, the epoch in which ``torch.profiler`` reports device events.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from repro_torch.sim.simtime import WallClock, active_clock

__all__ = ["Span", "Tracer", "tracer", "install_tracer", "use_tracer"]


def _paper_now() -> float:
    clk = active_clock()
    return clk.now() / clk.scale


class Span:
    """One traced interval (``t1 == t0`` for instant events)."""

    __slots__ = ("name", "cat", "trace_id", "t0", "t1", "args", "parent")

    def __init__(self, name: str, cat: str, trace_id: str, t0: float,
                 args: Optional[Dict[str, Any]], parent: Optional["Span"]):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.t0 = t0
        self.t1 = t0
        self.args: Dict[str, Any] = args if args is not None else {}
        self.parent = parent

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def set(self, key: str, value: Any) -> "Span":
        """Attach/overwrite one arg on an open span."""
        self.args[key] = value
        return self

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"trace_id={self.trace_id!r}, t0={self.t0:.6f}, "
                f"dur={self.duration:.6f})")


class _NullSpan:
    """Returned by a disabled tracer: absorbs ``set`` calls, records
    nothing."""

    __slots__ = ()
    name = cat = trace_id = ""
    t0 = t1 = duration = 0.0
    args: Dict[str, Any] = {}
    parent = None

    def set(self, key: str, value: Any) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _Scope:
    """What ``Tracer.span`` returns: a plain context manager, which costs
    the hot paths that open a span each step (a decode step, a train
    step's phases) less than a generator's."""

    __slots__ = ("_tr", "_name", "_cat", "_trace_id", "_parent", "_args",
                 "_sp", "_stack")

    def __init__(self, tr: "Tracer", name: str, cat: str, trace_id: str,
                 parent: Optional[Span], args: Optional[Dict[str, Any]]):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._trace_id = trace_id
        self._parent = parent
        self._args = args

    def __enter__(self) -> Span:
        tls = self._tr._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        parent, trace_id = self._parent, self._trace_id
        if parent is None and stack:
            parent = stack[-1]
        if not trace_id and parent is not None:
            trace_id = parent.trace_id
        sp = self._sp = Span(self._name, self._cat, trace_id, _paper_now(),
                             self._args, parent)
        self._stack = stack
        stack.append(sp)
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._sp
        if exc_type is not None:
            sp.args.setdefault("error", exc_type.__name__)
        self._stack.pop()
        sp.t1 = _paper_now()
        self._tr._record(sp)
        return False


class _NullScope:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SCOPE = _NullScope()


class Tracer:
    """Thread-safe span recorder.

    ``max_records`` bounds memory for long-lived daemon instrumentation;
    past it the oldest records are evicted and counted in ``dropped``, so
    a long-lived job keeps its newest spans (exports in tests/smokes use
    fresh tracers and never get near the cap).
    """

    def __init__(self, enabled: bool = True, max_records: int = 200_000):
        self.enabled = enabled
        self.max_records = max_records
        self.dropped = 0
        self._lock = threading.Lock()
        self._done: Deque[Span] = collections.deque(maxlen=max_records)
        self._tls = threading.local()
        self._anchor = _wall_anchor()

    # -- recording ----------------------------------------------------------
    def current(self) -> Optional[Span]:
        """Innermost open span on this thread (None outside any span)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def span(self, name: str, *, cat: str = "", trace_id: str = "",
             parent: Optional[Span] = None,
             args: Optional[Dict[str, Any]] = None) -> "_Scope":
        """Context manager yielding the span it opens on entry and records
        on exit (an exception's type as its ``error`` arg)."""
        if not self.enabled:
            return _NULL_SCOPE
        return _Scope(self, name, cat, trace_id, parent, args)

    def event(self, name: str, *, cat: str = "", trace_id: str = "",
              args: Optional[Dict[str, Any]] = None) -> None:
        """Record an instant event (zero-duration span)."""
        if not self.enabled:
            return
        parent = self.current()
        if not trace_id and parent is not None:
            trace_id = parent.trace_id
        sp = Span(name, cat, trace_id, _paper_now(), args, parent)
        self._record(sp)

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._done) == self.max_records:
                self.dropped += 1
            self._done.append(sp)

    # -- querying -----------------------------------------------------------
    def spans(self, cat: Optional[str] = None,
              trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Finished spans in record order, optionally filtered."""
        with self._lock:
            out = list(self._done)
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def reset(self) -> None:
        with self._lock:
            self._done.clear()
            self.dropped = 0
            self._anchor = _wall_anchor()

    def wall_ns(self, sp: Span) -> Optional[Tuple[int, int]]:
        """A finished span's ``(t0, t1)`` in ``time.time_ns()``'s epoch;
        None unless the installed clock is the ``WallClock``."""
        clk = active_clock()
        if not isinstance(clk, WallClock):
            return None
        mono, wall = self._anchor
        return (round(sp.t0 * clk.scale * 1e9) - mono + wall,
                round(sp.t1 * clk.scale * 1e9) - mono + wall)

    # -- canonical export ---------------------------------------------------
    def _canonical(self) -> List[Dict[str, Any]]:
        """Sorted, id-renumbered rows — the deterministic export form."""
        with self._lock:
            done = list(self._done)

        def key(s: Span):
            return (s.trace_id, s.t0, s.t1, s.cat, s.name,
                    json.dumps(s.args, sort_keys=True, default=str))

        order = sorted(done, key=key)
        ids = {id(s): f"s{i:06d}" for i, s in enumerate(order)}
        rows = []
        for i, s in enumerate(order):
            rows.append({
                "id": ids[id(s)],
                # a parent still open at export time has no id yet -> None
                "parent": ids.get(id(s.parent)) if s.parent is not None
                else None,
                "trace_id": s.trace_id,
                "cat": s.cat,
                "name": s.name,
                "ts": s.t0,
                "dur": s.t1 - s.t0,
                "args": {k: s.args[k] for k in sorted(s.args)},
            })
        return rows

    def to_jsonl(self) -> str:
        return "".join(
            json.dumps(row, sort_keys=True, default=str) + "\n"
            for row in self._canonical())

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per line; returns the record count."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return text.count("\n")

    def to_chrome(self) -> str:
        """Chrome trace-event JSON (Perfetto-viewable)."""
        rows = self._canonical()
        # one tid per trace_id, numbered by first appearance in canonical
        # order (i.e. sorted trace_id order) — hash-seed independent
        tids: Dict[str, int] = {}
        for row in rows:
            tids.setdefault(row["trace_id"], len(tids) + 1)
        events: List[Dict[str, Any]] = []
        for tid_name, tid in tids.items():
            events.append({
                "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                "args": {"name": tid_name or "(untraced)"},
            })
        for row in rows:
            ev: Dict[str, Any] = {
                "name": row["name"],
                "cat": row["cat"] or "misc",
                "pid": 1,
                "tid": tids[row["trace_id"]],
                "ts": round(row["ts"] * 1e6, 3),   # paper µs
                "args": dict(row["args"], trace_id=row["trace_id"],
                             id=row["id"], parent=row["parent"]),
            }
            if row["dur"] > 0.0:
                ev["ph"] = "X"
                ev["dur"] = round(row["dur"] * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        return json.dumps(doc, sort_keys=True, default=str,
                          separators=(",", ":"))

    def export_chrome(self, path: str) -> int:
        text = self.to_chrome()
        with open(path, "w") as f:
            f.write(text)
        with self._lock:
            return len(self._done)


def _wall_anchor() -> Tuple[int, int]:
    """``(time.monotonic_ns(), time.time_ns())`` read together: the wall
    reading is the mean of two taken either side of the monotonic one."""
    w0 = time.time_ns()
    mono = time.monotonic_ns()
    return mono, (w0 + time.time_ns()) // 2


# ---------------------------------------------------------------------------
# Process-global tracer, mirroring sim.simtime's active-clock idiom.
# ---------------------------------------------------------------------------
_TRACER = Tracer()
_TRACER_LOCK = threading.Lock()


def tracer() -> Tracer:
    return _TRACER


def install_tracer(tr: Tracer) -> Tracer:
    global _TRACER
    with _TRACER_LOCK:
        prev, _TRACER = _TRACER, tr
    return prev


@contextmanager
def use_tracer(tr: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Temporarily install ``tr`` (a fresh tracer when None)."""
    tr = tr if tr is not None else Tracer()
    prev = install_tracer(tr)
    try:
        yield tr
    finally:
        install_tracer(prev)
