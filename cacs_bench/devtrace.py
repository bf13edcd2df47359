"""The device side of a traced window: ``torch.profiler`` over the CUDA
activity alone, reduced to busy time, kernel times by name and the idle
gaps between them.

Device timestamps come in the same epoch nanoseconds as ``time.time_ns()``,
so a driver labels each idle gap by what its host was doing then.
"""
from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional, Tuple

Interval = Tuple[int, int]


def kernel_name(full: str) -> str:
    """``void ns::k<float>(float const*, ...)`` -> ``k``."""
    s = re.sub(r"^void\s+", "", full.strip())
    s = s.replace("(anonymous namespace)::", "")
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1][:80] or full[:80]


class DeviceWindow:
    """Profiles the device from ``start()`` to ``stop()``; the window the
    metrics read is ``[t_open, t_close]`` (epoch ns), set by the driver
    inside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t_open: Optional[int] = None
        self.t_close: Optional[int] = None
        self.events: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()

    def open(self) -> None:
        self.t_open = time.time_ns()

    def close(self) -> None:
        self.t_close = time.time_ns()

    def stop(self) -> None:
        """End the profile and keep the device events of the window."""
        if self.prof is None:
            return
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        lo, hi = self.t_open, self.t_close
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s, d = e.start_ns(), e.duration_ns()
            if d <= 0 or s + d <= lo or s >= hi:
                continue
            self.events.append((kernel_name(e.name()), s, s + d))
        self.events.sort(key=lambda ev: ev[1])
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t_close - self.t_open) / 1e9

    def busy(self) -> List[Interval]:
        """The union of the device's intervals, clipped to the window."""
        out: List[Interval] = []
        for _, s, e in self.events:
            s, e = max(s, self.t_open), min(e, self.t_close)
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, s, e in self.events:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, label: Callable[[int, int], str],
                  n: int = 10) -> List[list]:
        """The ``n`` longest idle stretches of the window, each named by
        ``label(start_ns, end_ns)``: what the host was doing then."""
        gaps, t = [], self.t_open
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t_close > t:
            gaps.append((t, self.t_close))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[label(s, e), (e - s) / 1e9] for s, e in gaps[:n]]
