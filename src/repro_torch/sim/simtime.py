"""Virtual-time layer: the ``Clock`` protocol, the wall-clock production
implementation, and the discrete-event ``SimClock``.

The repo models two kinds of durations:

* **paper seconds** — quantities calibrated against the paper (boot costs,
  iteration times, fault-schedule offsets).  Under the wall clock one paper
  second costs ``TIME_SCALE`` wall seconds (``sim_sleep``'s compression).
* **wall-tuned seconds** — raw operational knobs (monitor poll interval,
  scheduler tick, store latency) that were historically real wall seconds.

``SimClock`` unifies both onto a single virtual axis whose unit is the
paper second: paper durations map 1:1, wall-tuned durations map through
``1/TIME_SCALE`` — so every *relative* timing in the system is identical
to a wall-clock run, only nothing ever actually sleeps.  Virtual time
advances by jumping straight to the earliest pending deadline in one
priority queue of ``(deadline, seq)`` waiters (deterministic FIFO
tie-break), which is what turns a multi-day scenario into milliseconds.

Production code paths never change behavior: the default installed clock
is ``WallClock`` and every method degenerates to ``time.sleep`` /
``Event.wait`` exactly as before.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional, Protocol, Set, Tuple

# One paper (virtual) second costs this many wall seconds under the wall
# clock.  This is the canonical definition; ``repro_torch.clusters.simulator``
# re-exports it for backward compatibility.
TIME_SCALE = 0.01


class Clock(Protocol):
    """What the control plane needs from a time source.

    ``scale`` is *native seconds per paper second* (``TIME_SCALE`` for the
    wall clock, ``1.0`` for ``SimClock``), so ``(t1 - t0) / clock.scale``
    converts any pair of same-clock stamps to paper seconds.
    """

    scale: float

    def now(self) -> float: ...                       # native, monotonic
    def timestamp(self) -> float: ...                 # native, history stamps
    def sleep(self, wall_s: float) -> None: ...       # wall-tuned duration
    def paper_sleep(self, paper_s: float) -> None: ...
    def sleep_until(self, t_native: float) -> None: ...
    def from_wall(self, wall_s: float) -> float: ...  # wall-tuned -> native
    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool: ...  # wall-tuned


class WallClock:
    """Real time.  Behaviorally identical to the pre-Clock code paths."""

    scale = TIME_SCALE

    def now(self) -> float:
        return time.monotonic()

    def timestamp(self) -> float:
        return time.time()

    def from_wall(self, wall_s: float) -> float:
        return wall_s

    def sleep(self, wall_s: float) -> None:
        if wall_s > 0:
            time.sleep(wall_s)

    def paper_sleep(self, paper_s: float) -> None:
        if paper_s > 0:
            time.sleep(paper_s * TIME_SCALE)

    def sleep_until(self, t_native: float) -> None:
        self.sleep(t_native - self.now())

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        return event.wait(timeout)


# ---------------------------------------------------------------------------
# Deterministic event queue (shared by SimClock's waiter heap and the pure
# single-threaded engine in repro_torch.sim.engine).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Event:
    """One scheduled occurrence.  Ordering is ``(time, seq)`` — ``seq`` is
    assignment order, so ties break FIFO and a replay that schedules the
    same events in the same order pops them in the identical order
    regardless of ``PYTHONHASHSEED`` (nothing here hashes anything)."""
    time: float
    seq: int
    kind: str
    payload: Any = None
    cancelled: bool = False


class EventQueue:
    """Priority queue of :class:`Event` with deterministic tie-breaking,
    O(log n) schedule/pop and O(1) cancel (lazy deletion)."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._live = 0

    def __len__(self) -> int:
        return self._live

    def schedule(self, at: float, kind: str, payload: Any = None) -> Event:
        ev = Event(time=float(at), seq=next(self._seq), kind=kind,
                   payload=payload)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._live += 1
        return ev

    def cancel(self, ev: Event) -> bool:
        """Cancel a pending event; returns False if already fired/cancelled."""
        if ev.cancelled:
            return False
        ev.cancelled = True
        self._live -= 1
        return True

    def reschedule(self, ev: Event, at: float) -> Event:
        """Cancel ``ev`` and schedule a fresh event at ``at`` (new seq —
        a rescheduled event loses its place in the FIFO tie-break)."""
        self.cancel(ev)
        return self.schedule(at, ev.kind, ev.payload)

    def _drop_cancelled(self) -> None:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        self._drop_cancelled()
        return self._heap[0][2] if self._heap else None

    def next_time(self) -> Optional[float]:
        ev = self.peek()
        return None if ev is None else ev.time

    def pop(self) -> Optional[Event]:
        self._drop_cancelled()
        if not self._heap:
            return None
        ev = heapq.heappop(self._heap)[2]
        self._live -= 1
        return ev

    def drain(self) -> Iterator[Event]:
        while True:
            ev = self.pop()
            if ev is None:
                return
            yield ev


# ---------------------------------------------------------------------------
# SimClock — the discrete-event virtual clock for the threaded stack.
# ---------------------------------------------------------------------------

class SimClock:
    """Auto-advancing virtual clock.

    Every sleeper/waiter registers a ``(deadline, seq)`` entry in one
    priority queue; a background advancer jumps ``now`` to the earliest
    pending deadline whenever waiters exist (after a tiny wall ``grace_s``
    so threads that just woke can reach their next sleep and keep their
    relative pacing).  Deadlines are computed as ``now + dt`` at sleep
    time, so advancing never violates causality.

    Native unit: the paper second.  ``sleep()`` takes historically
    wall-tuned durations and maps them through ``1/TIME_SCALE`` so all
    relative cadences (monitor poll vs. app iteration vs. store latency)
    match a wall-clock run exactly.
    """

    # how long Event.wait-style blocking may go unnoticed after a set()
    # that nobody notifies the clock about (pure wall backstop)
    _POLL_CAP_S = 0.02

    def __init__(self, start: float = 0.0, grace_s: float = 0.0002):
        self.scale = 1.0
        self.grace_s = grace_s
        self._now = float(start)
        self._cond = threading.Condition()
        self._waiters: List[Tuple[float, int]] = []    # (deadline, seq)
        self._seq = itertools.count()
        self._dead: Set[int] = set()                   # abandoned waiters
        self._closed = False
        self.advances = 0                              # observability
        self._thread = threading.Thread(
            target=self._advance_loop, daemon=True, name="simclock-advancer")
        self._thread.start()

    # ---- Clock protocol -------------------------------------------------
    def now(self) -> float:
        return self._now

    def timestamp(self) -> float:
        return self._now

    def from_wall(self, wall_s: float) -> float:
        return wall_s / TIME_SCALE

    def sleep(self, wall_s: float) -> None:
        self.sleep_virtual(self.from_wall(wall_s))

    def paper_sleep(self, paper_s: float) -> None:
        self.sleep_virtual(paper_s)

    def sleep_until(self, t_native: float) -> None:
        self.sleep_virtual(t_native - self._now)

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        """Virtual-deadline Event.wait.  A set() is noticed within
        ``_POLL_CAP_S`` wall seconds; the timeout elapses in virtual time
        (instantly, when the system is otherwise idle)."""
        if event.is_set():
            return True
        if self._closed:
            return event.is_set()
        if timeout is None:
            while not self._closed and not event.wait(self._POLL_CAP_S):
                pass
            return event.is_set()
        with self._cond:
            deadline = self._now + self.from_wall(timeout)
            seq = next(self._seq)
            heapq.heappush(self._waiters, (deadline, seq))
            self._cond.notify_all()
            try:
                while not self._closed and self._now < deadline:
                    if event.is_set():
                        return True
                    self._cond.wait(self._POLL_CAP_S)
            finally:
                if self._now < deadline:        # early exit: drop the entry
                    self._dead.add(seq)
        return event.is_set()

    # ---- internals -------------------------------------------------------
    def sleep_virtual(self, dt: float) -> None:
        if dt <= 0 or self._closed:
            return
        with self._cond:
            deadline = self._now + dt
            heapq.heappush(self._waiters, (deadline, next(self._seq)))
            self._cond.notify_all()
            while not self._closed and self._now < deadline:
                self._cond.wait(self._POLL_CAP_S)

    def pending_deadlines(self) -> Tuple[float, ...]:
        """Sorted snapshot of the live waiter deadlines. Introspection
        for tests: "is some thread pinned in a long virtual sleep?" can
        be answered directly instead of being inferred from wall-time
        thread scheduling (which is racy on a loaded machine)."""
        with self._cond:
            return tuple(sorted(d for d, seq in self._waiters
                                if seq not in self._dead))

    def _prune(self) -> None:
        while self._waiters and self._waiters[0][1] in self._dead:
            self._dead.discard(heapq.heappop(self._waiters)[1])

    def _advance_loop(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                self._prune()
                if not self._waiters:
                    self._cond.wait(0.05)
                    continue
            # grace outside the lock: threads that just woke get a moment
            # to register their next sleep before we pick the earliest
            # deadline — this is what preserves relative pacing
            if self.grace_s > 0:
                time.sleep(self.grace_s)
            with self._cond:
                if self._closed:
                    return
                self._prune()
                if not self._waiters:
                    continue
                deadline = self._waiters[0][0]
                if deadline > self._now:
                    self._now = deadline
                    self.advances += 1
                while self._waiters and self._waiters[0][0] <= self._now:
                    self._dead.discard(heapq.heappop(self._waiters)[1])
                self._cond.notify_all()

    def close(self) -> None:
        """Wake every sleeper immediately and stop advancing.  Idempotent;
        called by the test fixture before tearing services down so no
        daemon blocks teardown on a virtual deadline."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2)


# ---------------------------------------------------------------------------
# The installed clock.  Module-level so deep call sites (sim_sleep, store
# latency, daemon loops) need no signature changes; tests swap it with
# use_clock()/install_clock().
# ---------------------------------------------------------------------------

_WALL = WallClock()
_active: Clock = _WALL


def active_clock() -> Clock:
    return _active


def install_clock(clock: Optional[Clock]) -> Clock:
    """Install ``clock`` (None restores the wall clock); returns the
    previously installed clock."""
    global _active
    prev = _active
    _active = clock if clock is not None else _WALL
    return prev


@contextmanager
def use_clock(clock: Clock):
    prev = install_clock(clock)
    try:
        yield clock
    finally:
        install_clock(prev)
