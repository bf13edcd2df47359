"""Gang rank regions (port of the jax-free helpers of
``repro/sharding/specs.py``).

The reference module maps logical dims onto jax mesh axes and imports jax
at its top; that part waits for the port's distributed slice. What is
here is the partition a gang job's global state takes over its ranks.
"""
from __future__ import annotations

from typing import List, Tuple


# ---------------------------------------------------------------------------
# Gang rank regions (reshard-on-restore)
# ---------------------------------------------------------------------------
# A gang job's global state is partitioned over its ranks along one axis
# (rows of the lead dimension, like a 1-D data-parallel mesh). These
# helpers are the single source of truth for that partition on BOTH sides:
# the gang writer stamps each rank's chunk at its region's global offset,
# and the gang restore recomputes regions for a *different* rank count —
# the reader's region-overlap assembly then reshards for free.

def even_regions(dim: int, n: int) -> List[Tuple[int, int]]:
    """Split ``dim`` rows over ``n`` ranks: [(offset, length)] per rank.

    The remainder spreads over the leading ranks (lengths differ by at
    most 1), every row is owned by exactly one rank, and the split is a
    pure function of (dim, n) — deterministic across save and restore.
    """
    if n <= 0:
        raise ValueError(f"need at least one rank, got {n}")
    base, rem = divmod(dim, n)
    regions, off = [], 0
    for r in range(n):
        length = base + (1 if r < rem else 0)
        regions.append((off, length))
        off += length
    return regions


def rank_region(shape: Tuple[int, ...], n_ranks: int, rank: int,
                axis: int = 0) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """One rank's (offset, shape) of a global array sharded along ``axis``."""
    off, length = even_regions(shape[axis], n_ranks)[rank]
    offset = tuple(off if i == axis else 0 for i in range(len(shape)))
    shp = tuple(length if i == axis else d for i, d in enumerate(shape))
    return offset, shp


def owner_of_row(dim: int, n_ranks: int, row: int) -> int:
    """Which rank owns ``row`` under ``even_regions(dim, n_ranks)`` —
    used to re-route drained in-flight messages after a reshard."""
    for r, (off, length) in enumerate(even_regions(dim, n_ranks)):
        if off <= row < off + length:
            return r
    raise ValueError(f"row {row} outside [0, {dim})")
