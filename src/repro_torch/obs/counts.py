"""Counts a step adds to, read and written as one."""
from __future__ import annotations

from typing import Any, List, Sequence

from repro_torch.obs.telemetry import registry


class CountSet:
    """Registry counters by name and keys of module dicts as ``(dict,
    key)``. What a step adds to them is read around it and added again
    where it replays without its Python (a CUDA graph)."""

    def __init__(self, counters: Sequence[Any]):
        self.counters = tuple(counters)

    def read(self) -> List[float]:
        return [c[0][c[1]] if isinstance(c, tuple) else registry().value(c)
                for c in self.counters]

    def write(self, values: Sequence[float]) -> None:
        """Put back what ``read`` gave (making no registry counter)."""
        for c, v in zip(self.counters, values):
            if isinstance(c, tuple):
                c[0][c[1]] = v
            elif registry().get(c) is not None:
                registry().counter(c).value = v

    def add(self, deltas: Sequence[float]) -> None:
        for c, n in zip(self.counters, deltas):
            if isinstance(c, tuple):
                c[0][c[1]] += n
            elif n:
                registry().inc(c, n)
