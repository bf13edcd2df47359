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
"""
from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.sim.simtime import active_clock

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


class Tracer:
    """Thread-safe span recorder.

    ``max_records`` bounds memory for long-lived daemon instrumentation;
    past it new records are dropped and counted in ``dropped`` (exports in
    tests/smokes use fresh tracers and never get near the cap).
    """

    def __init__(self, enabled: bool = True, max_records: int = 200_000):
        self.enabled = enabled
        self.max_records = max_records
        self.dropped = 0
        self._lock = threading.Lock()
        self._done: List[Span] = []
        self._tls = threading.local()

    # -- recording ----------------------------------------------------------
    def current(self) -> Optional[Span]:
        """Innermost open span on this thread (None outside any span)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, *, cat: str = "", trace_id: str = "",
             parent: Optional[Span] = None,
             args: Optional[Dict[str, Any]] = None):
        if not self.enabled:
            yield _NULL
            return
        if parent is None:
            parent = self.current()
        if not trace_id and parent is not None:
            trace_id = parent.trace_id
        sp = Span(name, cat, trace_id, _paper_now(), args, parent)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.args.setdefault("error", type(exc).__name__)
            raise
        finally:
            stack.pop()
            sp.t1 = _paper_now()
            self._record(sp)

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
            if len(self._done) >= self.max_records:
                self.dropped += 1
                return
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
