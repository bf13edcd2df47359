"""The numbers a correctness check compares, each against the
reference's, worst leaf first."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Optional[Iterable[str]] = None) -> float:
    """max over leaves of |got - want| / max(want, median leaf of want):
    the gap between two norms, not the norm of a difference, against the
    leaf's own norm or the median leaf's, whichever is larger."""
    names = sorted(want if leaves is None else leaves)
    if not names:
        return float("inf")
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in names)


def moved_leaves(grad_norms: Dict[str, float],
                 floor: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``floor`` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_norms.values())
    return sorted(n for n, g in grad_norms.items() if g >= floor * med)
