"""Serving-fleet workload primitives (pure stdlib — no jax, no service).

Three pieces shared by the real-stack FleetController (serve/fleet.py)
and the discrete-event request-storm engine (sim/serve.py):

* :class:`FleetPolicy` — the autoscaler's knobs (floor/ceiling, target
  load per replica, idle threshold for scale-in).
* :class:`RequestTrace` — a seeded diurnal + bursty request-arrival
  process. Arrivals are a nonhomogeneous Poisson stream generated by
  thinning: the rate follows a raised-cosine day curve between
  ``base_qps`` and ``peak_qps``, multiplied by ``burst_mult`` inside
  seeded burst windows. Iterating the trace yields arrival times lazily
  (millions of requests without materializing a list), and every
  ``iter()`` restarts the identical stream — same seed, same bytes —
  so a pooled and a static fleet can be driven by *the same* trace.
* :class:`Router` — deterministic least-outstanding request router:
  ties break on the lowest replica id, membership changes are explicit,
  and no dict/set iteration order reaches a routing decision, so a
  seeded scenario replays exactly.

Port of ``repro/serve/workload.py``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Autoscaling knobs for a checkpoint-backed serving fleet."""
    min_replicas: int = 1
    max_replicas: int = 8
    # scale OUT when demand per live replica exceeds this fraction of a
    # replica's service capacity (concurrency / service_s in the DES,
    # target_inflight outstanding requests on the real stack)
    target_util: float = 0.75
    target_inflight: float = 4.0
    # scale IN a replica only after it has served nothing for this long
    scale_in_idle_s: float = 30.0
    eval_period_s: float = 5.0       # autoscaler evaluation cadence
    cooldown_s: float = 0.0          # min spacing between scale actions


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """Seeded diurnal + bursty arrival process (restartable iterator)."""
    seed: int
    horizon_s: float
    base_qps: float                  # trough arrival rate
    peak_qps: float                  # diurnal peak arrival rate
    period_s: float = 86400.0        # one "day"
    burst_every_s: float = 0.0       # mean burst spacing (0 = no bursts)
    burst_s: float = 60.0            # burst window length
    burst_mult: float = 3.0          # rate multiplier inside a burst

    def diurnal_rate(self, t: float) -> float:
        """Raised-cosine day curve: trough at t=0, peak at period/2."""
        frac = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period_s))
        return self.base_qps + (self.peak_qps - self.base_qps) * frac

    def burst_windows(self) -> List[Tuple[float, float]]:
        """Seeded burst windows (their own rng stream, so the window
        schedule is stable regardless of how many arrivals were drawn)."""
        if self.burst_every_s <= 0:
            return []
        rng = random.Random((self.seed << 1) ^ 0x9E3779B9)
        windows: List[Tuple[float, float]] = []
        t = rng.expovariate(1.0 / self.burst_every_s)
        while t < self.horizon_s:
            windows.append((t, min(t + self.burst_s, self.horizon_s)))
            t += self.burst_s + rng.expovariate(1.0 / self.burst_every_s)
        return windows

    def rate(self, t: float,
             windows: Optional[List[Tuple[float, float]]] = None) -> float:
        if windows is None:
            windows = self.burst_windows()
        lam = self.diurnal_rate(t)
        for lo, hi in windows:
            if lo <= t <= hi:
                return lam * self.burst_mult
            if lo > t:
                break
        return lam

    def __iter__(self) -> Iterator[float]:
        """Yield arrival times in (0, horizon_s), strictly increasing.
        Thinning against the global max rate keeps the stream exact for
        the seed no matter how the rate curve is shaped."""
        rng = random.Random(self.seed)
        windows = self.burst_windows()
        lam_max = self.peak_qps * (self.burst_mult if windows else 1.0)
        wi = 0
        t = 0.0
        while True:
            t += rng.expovariate(lam_max)
            if t >= self.horizon_s:
                return
            while wi < len(windows) and t > windows[wi][1]:
                wi += 1
            in_burst = (wi < len(windows)
                        and windows[wi][0] <= t <= windows[wi][1])
            lam = self.diurnal_rate(t) * (self.burst_mult if in_burst
                                          else 1.0)
            if rng.random() * lam_max <= lam:
                yield t


class Router:
    """Deterministic least-outstanding router over live replica ids.

    ``route()`` picks the member with the fewest outstanding requests,
    breaking ties on the smallest id — a pure function of the call
    history, so two replays of the same request sequence against the
    same membership events route identically.
    """

    def __init__(self) -> None:
        self._outstanding: Dict[str, int] = {}
        self.routed = 0
        self.rejected = 0                # routed with no live replica

    def add(self, replica_id: str) -> None:
        self._outstanding.setdefault(replica_id, 0)

    def remove(self, replica_id: str) -> None:
        self._outstanding.pop(replica_id, None)

    def members(self) -> List[str]:
        return sorted(self._outstanding)

    def outstanding(self, replica_id: Optional[str] = None) -> int:
        if replica_id is not None:
            return self._outstanding.get(replica_id, 0)
        return sum(self._outstanding.values())

    def route(self) -> Optional[str]:
        """Pick a replica for one request (None when the fleet is empty);
        the pick's outstanding count is incremented until ``complete``."""
        if not self._outstanding:
            self.rejected += 1
            return None
        rid = min(sorted(self._outstanding),
                  key=lambda r: (self._outstanding[r], r))
        self._outstanding[rid] += 1
        self.routed += 1
        return rid

    def complete(self, replica_id: str) -> None:
        n = self._outstanding.get(replica_id)
        if n is not None and n > 0:
            self._outstanding[replica_id] = n - 1
