"""Logical-dims → mesh-axes mapping (DP / FSDP / TP / EP / SP), and the
gang rank regions (port of ``repro/sharding/specs.py``).

Every parameter leaf is created with a tuple of *logical dim names*
(``repro_torch.models.layers.ParamBuilder``). This module maps those
names onto the named dims of a ``torch.distributed`` ``DeviceMesh``, with
the reference's divisibility-checked fallbacks. A spec is a plain tuple
with ``PartitionSpec``'s meaning, one entry per tensor dim: an axis name,
a tuple of axis names (major to minor), or ``None``; a one-name tuple is
written as the name, as ``PartitionSpec`` normalizes it. The torch side:
``mesh_placements`` turns a spec into the mesh's DTensor placements (a
tuple entry becomes ``Shard(d)`` on each of its mesh dims, in mesh
order: DTensor shards mesh dim 0 first, so the leading axis is the major
one, as in JAX's ``devices_indices_map``), ``local_region`` gives one
rank's (offset, shape) under them, ``distribute`` and ``full_tensor``
move a tensor between its whole and its sharded form with explicit
collectives (``all_gather`` in each sharding mesh dim's group, which
gloo runs on CUDA tensors too).

The reference's ``constrain`` (activation sharding inside the model,
GSPMD's model-axis split of heads, ff and experts) has no counterpart
yet: the port's sharded step replicates compute over the model axis and
shards only the state there. ``activation_sharding`` and
``active_axis_size`` keep the reference's context for code that reads it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Which mesh axes implement each parallelism flavour."""
    dp: Tuple[str, ...]              # batch axes (("pod","data") or ("data",))
    fsdp: Optional[str]              # param-shard axis (subset of dp) or None
    tp: Optional[str]                # tensor-parallel axis
    ep: Optional[str]                # expert-parallel axis
    sp: Optional[str]                # sequence-shard axis (long prefill)
    sizes: Mapping[str, int]         # axis name -> size

    def size(self, ax: Optional[str]) -> int:
        return 1 if ax is None else self.sizes[ax]


def make_axes(mesh: DeviceMesh, *, use_fsdp: bool = False,
              seq_shard: bool = False) -> MeshAxes:
    """The parallelism flavours of a mesh, read from its dim names and
    shape."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(s) for s in mesh.shape)))
    dp = tuple(n for n in names if n in ("pod", "data"))
    tp = "model" if "model" in names else None
    return MeshAxes(
        dp=dp,
        fsdp="data" if (use_fsdp and "data" in names) else None,
        tp=tp,
        ep=tp,
        sp=tp if seq_shard else None,
        sizes=sizes,
    )


# Logical param-dim name -> which MeshAxes field shards it. Names ending in
# "_nt" are never sharded (small / replicated tensors).
_PARAM_RULES = {
    "vocab": "tp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,        # fallback target — see combined rule below
    "ff": "tp",
    "experts": "ep",
    "moe_embed": "fsdp",
    "moe_ff": None,
    "ssm_inner": "tp",
    "xl_inner": "tp",
    "xl_inner2": None,
    "layers": None,
    # activation/cache dims (serve-state leaves)
    "batch": "dp",
    "kvseq": "dp",     # context-parallel KV when batch can't shard (long_500k)
}


def _axis_for(name: Optional[str], axes: MeshAxes) -> Optional[str]:
    if name is None or name.endswith("_nt"):
        return None
    field = _PARAM_RULES.get(name)
    if field is None:
        return None
    return getattr(axes, field)


def leaf_spec(dims: Tuple[Optional[str], ...], shape: Tuple[int, ...],
              axes: MeshAxes) -> Spec:
    """Spec for one leaf, with divisibility fallbacks.

    Combined rule: if a ``heads``/``kv_heads`` dim is not divisible by the tp
    axis, tp falls back to that leaf's ``head_dim`` dim (if divisible) — the
    standard GQA layout escape when head counts don't divide TP.
    """
    assignment: list = [None] * len(dims)
    used: set = set()

    def try_assign(i: int, ax: Any) -> bool:
        if ax is None:
            return False
        ax_t = ax if isinstance(ax, tuple) else (ax,)
        total = math.prod(axes.size(a) for a in ax_t)
        if any(a in used for a in ax_t):
            return False
        if shape[i] % total != 0 or total == 1:
            return False
        assignment[i] = ax_t[0] if len(ax_t) == 1 else ax_t
        used.update(ax_t)
        return True

    head_fallback_needed = False
    for i, name in enumerate(dims):
        ax = _axis_for(name, axes)
        ok = try_assign(i, ax)
        # Q heads fall back to head_dim sharding. KV *projection weights*
        # whose head count doesn't divide TP are REPLICATED; KV *caches*
        # ("kvseq" present) keep the head_dim fallback.
        if not ok and axes.tp and (
                name == "heads"
                or (name == "kv_heads" and "kvseq" in dims)):
            head_fallback_needed = True
    if head_fallback_needed and axes.tp not in used:
        for i, name in enumerate(dims):
            if name == "head_dim" and try_assign(i, axes.tp):
                break
    return tuple(assignment)


def map_dims(fn, dims_tree: Any, *rest: Any) -> Any:
    """``fn(dims, *leaves)`` over a dims tree (nested dicts whose leaves are
    dim tuples, ``()`` for a scalar) and trees of its structure."""
    if isinstance(dims_tree, dict):
        return {k: map_dims(fn, v, *(r[k] for r in rest))
                for k, v in dims_tree.items()}
    return fn(tuple(dims_tree), *rest)


def param_specs(dims_tree: Any, shapes_tree: Any, axes: MeshAxes) -> Any:
    """Map matching (dims, shaped) trees to a spec tree; a shaped leaf is a
    tensor (``meta`` ones included) or a shape."""
    def one(dims, shaped):
        shape = shaped.shape if hasattr(shaped, "shape") else tuple(shaped)
        return leaf_spec(dims, tuple(shape), axes)
    return map_dims(one, dims_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh: placements, regions, DTensor leaves
# ---------------------------------------------------------------------------

def mesh_placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """A spec -> one placement per mesh dim: ``Shard(d)`` on every mesh dim
    that a spec entry ``d`` names, ``Replicate()`` on the others. A tuple
    entry must list its axes in mesh order (major to minor), the order
    DTensor shards in."""
    names = tuple(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axs = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshSharding:
    """Where a leaf lives on a mesh: the mesh and its spec (one leaf of a
    ``shardings`` tree for ``ckpt.restore``)."""
    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return mesh_placements(self.spec, self.mesh)


def shardings(spec_tree: Any, mesh: DeviceMesh) -> Any:
    """A spec tree (from ``param_specs``) -> a tree of ``MeshSharding``."""
    return map_dims(lambda spec: MeshSharding(mesh, spec), spec_tree)


def local_region(shape: Sequence[int], placements: Sequence[Placement],
                 mesh_shape: Sequence[int], coord: Sequence[int]
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offset, shape) of the shard held at mesh coordinate ``coord``.

    The mesh dims that shard one tensor dim fold into one index, the
    first the major one. Every shard must be whole: a dim that its mesh
    dims do not divide is refused (``leaf_spec`` never assigns one)."""
    offset, size = [0] * len(shape), list(shape)
    for d in range(len(shape)):
        idx, n = 0, 1
        for i, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == d:
                idx, n = idx * mesh_shape[i] + coord[i], n * mesh_shape[i]
        if n == 1:
            continue
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {n} shards")
        size[d] = shape[d] // n
        offset[d] = idx * size[d]
    for p in placements:
        if isinstance(p, Shard) and p.dim >= len(shape):
            raise ValueError(f"{p} on a {len(shape)}-d leaf")
    return tuple(offset), tuple(size)


def region_of(shape: Sequence[int], mesh: DeviceMesh,
              placements: Sequence[Placement]
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's (offset, shape) of a leaf placed on ``mesh``."""
    return local_region(shape, placements, tuple(mesh.shape),
                        mesh.get_coordinate())


def _slices(offset: Sequence[int], shape: Sequence[int]) -> Tuple[slice, ...]:
    return tuple(slice(o, o + s) for o, s in zip(offset, shape))


def wrap_local(local: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement],
               shape: Sequence[int]) -> DTensor:
    """This rank's shard -> a DTensor of global ``shape`` (no collective)."""
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def distribute(full: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement]) -> DTensor:
    """A whole tensor every rank holds -> its DTensor, keeping this rank's
    shard (a copy, so the whole may be freed)."""
    off, shp = region_of(full.shape, mesh, placements)
    local = full[_slices(off, shp)].contiguous().clone()
    return wrap_local(local, mesh, placements, full.shape)


def local_slice(full: torch.Tensor, dt: DTensor) -> torch.Tensor:
    """The part of a whole tensor that this rank holds of ``dt`` (a view)."""
    off, shp = region_of(dt.shape, dt.device_mesh, dt.placements)
    return full[_slices(off, shp)]


def full_tensor(dt: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank: ``all_gather`` in the
    group of each sharding mesh dim, the minor one first, so the parts
    concatenate in the order ``local_region`` lays them out."""
    local = dt.to_local()
    mesh = dt.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = dt.placements[i]
        if not isinstance(p, Shard) or mesh.size(i) == 1:
            continue
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
        dist.all_gather(parts, local, group=mesh.get_group(i))
        local = torch.cat(parts, dim=p.dim)
    return local


def dp_rows(batch: int, mesh: DeviceMesh,
            dp: Sequence[str]) -> Tuple[int, int]:
    """[lo, hi) of the rows of a global batch that this rank computes: its
    index over the data-parallel mesh dims ``dp``, the first the major
    one."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in dp:
        i = names.index(a)
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} "
                         f"data-parallel ranks")
    per = batch // n
    return idx * per, (idx + 1) * per


# ---------------------------------------------------------------------------
# Activation sharding context
# ---------------------------------------------------------------------------

_ACTIVE: Optional[MeshAxes] = None


def active_axis_size(kind: str) -> int:
    """Size of the active context's axis ("tp"/"dp"/...), 1 if no context."""
    if _ACTIVE is None:
        return 1
    ax = getattr(_ACTIVE, kind, None)
    if ax is None:
        return 1
    ax_t = ax if isinstance(ax, tuple) else (ax,)
    return math.prod(_ACTIVE.size(a) for a in ax_t)


@contextlib.contextmanager
def activation_sharding(axes: Optional[MeshAxes]):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, axes
    try:
        yield
    finally:
        _ACTIVE = prev


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
