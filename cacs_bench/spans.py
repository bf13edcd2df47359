"""The port tracer's spans on the device trace's clock, for the readers of
program spans and counters.

A reader takes the spans of the port's process-wide tracer
(``repro_torch.obs.trace.tracer()``), each with its interval in
``time.time_ns()``'s epoch (``Tracer.wall_ns``), the epoch of the run's
window (``run.window.t_open``, ``t_close``) and of the card's busy
intervals (``run.window.busy()``). Where the tracer holds no such span,
or its clock has no wall epoch, a reader reads nothing (None).
"""
from __future__ import annotations

import statistics
from typing import Any, List, Optional, Sequence, Tuple

Timed = Tuple[Any, int, int]            # (span, t0_ns, t1_ns)


def timed(name: str) -> List[Timed]:
    """Every finished span of that name, with its wall interval (none
    from a program whose tracer cannot place its spans on the wall)."""
    from repro_torch.obs.trace import tracer
    tr = tracer()
    wall_ns = getattr(tr, "wall_ns", None)
    out = []
    for sp in tr.spans(name=name):
        wall = wall_ns(sp) if wall_ns is not None else None
        if wall is None:
            return []
        out.append((sp, *wall))
    return out


def window(run) -> Optional[Tuple[int, int]]:
    w = run.window
    if w is None or w.t_open is None or w.t_close is None:
        return None
    return w.t_open, w.t_close


def ending_in(run, name: str) -> List[Timed]:
    """The spans of that name that end inside the window."""
    win = window(run)
    if win is None:
        return []
    return [t for t in timed(name) if win[0] <= t[2] <= win[1]]


def median_ms(spans: Sequence[Timed]) -> Optional[float]:
    """Median duration in ms."""
    if not spans:
        return None
    return statistics.median(t1 - t0 for _, t0, t1 in spans) / 1e6


def first_ending_in(run, name: str) -> Optional[Timed]:
    spans = sorted(ending_in(run, name), key=lambda t: t[2])
    return spans[0] if spans else None


def kept_steps(run) -> List[Timed]:
    """The ``train/step`` spans the window kept: those that begin after
    the window's ``app/resume`` ends and end by the close."""
    resume = first_ending_in(run, "app/resume")
    if resume is None:
        return []
    return [t for t in ending_in(run, "train/step") if t[1] >= resume[2]]


def phase_device_ms(run, name: str) -> Optional[float]:
    """Median ``device_ms`` of the ``name`` phase over the kept steps."""
    kept = {id(sp) for sp, _, _ in kept_steps(run)}
    ms = [sp.args["device_ms"] for sp, _, _ in timed(name)
          if id(sp.parent) in kept and "device_ms" in sp.args]
    return statistics.median(ms) if ms else None


def overlap(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """Total length of the intersection of two lists of disjoint
    intervals, each sorted by start."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(run) -> List[Tuple[int, int]]:
    """The window's stretches in which no operation ran on the card,
    sorted by start."""
    w = run.window
    gaps = w.idle_gaps(lambda s, e: (s, e), n=len(w.events) + 1)
    return sorted(g for g, _ in gaps)
