"""Logical-dims → mesh-axes mapping (DP / FSDP / TP / EP / SP), the
model-axis split of the forward, and the gang rank regions (port of
``repro/sharding/specs.py``).

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
gloo runs on CUDA tensors too); ``gather_except`` gathers only the mesh
dims a step does not keep local.

The context-parallel decode. Where a serving batch does not divide the
data axes, ``leaf_spec`` splits the caches over ``kvseq`` instead:
``kvseq_split``, ``serving_batch``, ``kvseq_slice``, ``kvseq_mark``,
``kvseq_range`` and ``merge_attention`` carry it (see their section); a
cache whose slots the data ranks do not divide stays whole on each of
them, and its tensors carry their global slot count to say so.

The model-axis split. GSPMD splits the reference's forward over the
``model`` axis where ``constrain`` asks it to; the port does the same
by hand. ``activation_sharding(axes, mesh)`` makes the mesh's groups
reachable from model code (``tp_group``, ``tp_rank``, ``ep_group``, the
data-parallel groups), ``constrain(x, dims)`` resolves an activation's
spec with the reference's rules and returns it (it moves no data: the
caller reads from it whether it holds a local slice), and the
differentiable collectives carry the forward and backward across the
split: ``copy_to_tp`` (identity forward, all-reduce backward) enters a
column-parallel region, ``reduce_from_tp`` (all-reduce forward, identity
backward) leaves a row-parallel one, ``gather_from_tp`` (all-gather
forward, the rank's slice backward) joins the pieces of a replicated
computation, ``relayout_halves`` (one all-to-all forward, the inverse
one backward) turns a rank's contiguous columns of a fused two-half
projection into its channels of each half, and ``dp_sum`` (all-reduce
forward over the data-parallel groups, identity backward) takes a sum
over the whole batch.

Sequence sharding between blocks (the reference's ``seq_shard``:
``make_axes(mesh, seq_shard=True)`` sets ``sp`` to the model axis).
Where ``seq_split`` says the sequence of the residual stream divides
over ``sp``, each model rank holds its ``S / tp`` rows of it between
blocks, and three more mappings carry it (Megatron-LM's
sequence-parallel ones): ``gather_from_sp`` (all-gather along the
sequence forward, reduce-scatter backward) enters a column-parallel
region in place of ``copy_to_tp``, ``reduce_scatter_to_sp``
(reduce-scatter forward, all-gather backward) leaves a row-parallel one
in place of ``reduce_from_tp``, and ``scatter_to_sp`` (the rank's slice
forward, all-gather backward) cuts a tensor every rank holds whole; a
region that runs whole on every rank is entered with
``gather_from_tp``. Every
collective issued through this module is counted in ``COLLECTIVES`` by
kind, as the kernels count ``LAUNCHES``. Inside ``collective_log()``
each one is also recorded with its bytes, its group and the call site
that issued it (the launch tooling's counterpart of the collectives an
XLA program lists, with their ``op_name``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def _all_gather(local: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``local`` along ``dim`` in group order."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    COLLECTIVES["all_gather"] += 1
    if _LOG is not None:
        _record("all_gather", local, group, len(parts))
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, this rank's slice of
    it along ``dim`` (the ranks' slices in group order). One list-form
    call on every backend; gloo takes it on host tensors only, so a CUDA
    tensor crosses through host memory there (gloo's own transport for
    CUDA tensors)."""
    n = dist.get_world_size(group)
    inp = t.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // n,) + tuple(inp.shape[1:]))
    host = dist.get_backend(group) == "gloo" and inp.device.type != "cpu"
    res = torch.empty_like(out, device="cpu") if host else out
    dist.reduce_scatter(res, list((inp.cpu() if host else inp).chunk(n)),
                        group=group)
    if host:
        out.copy_(res)
    COLLECTIVES["reduce_scatter"] += 1
    if _LOG is not None:
        _record("reduce_scatter", out, group, 1)
    return out.movedim(0, dim).contiguous()


def _all_reduce(t: torch.Tensor, groups: Sequence[Any],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``t`` over each group in turn (``t`` is left as
    it was)."""
    out = t.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(out, op=op, group=g)
        COLLECTIVES["all_reduce"] += 1
        if _LOG is not None:
            _record("all_reduce", out, g, 1)
    return out


# ---------------------------------------------------------------------------
# The collective log: each collective's bytes, group and call site
# ---------------------------------------------------------------------------

_LOG: Optional[List[Dict[str, Any]]] = None
_SITE: Optional[str] = None


@contextlib.contextmanager
def collective_log():
    """Record every collective issued through this module in the list it
    yields, one dict each: ``kind`` ("all_reduce", "all_gather",
    "reduce_scatter" or "all_to_all"), ``bytes`` (the buffer the
    collective leaves on this rank, at its own dtype: the reduced tensor,
    the gathered one, the reduced shard or the exchanged one, as an XLA
    program's result type gives them),
    ``dtype``, ``group`` (the active mesh's dim name for the group, else
    None), ``ranks`` (the group's global ranks) and ``site`` (the port
    function that issued it, then the stack's block, ``labelled``, and
    "backward" for a collective of an autograd backward)."""
    global _LOG
    prev, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = prev


def labelled(blocks):
    """Iterate ``blocks`` (a stack's ``Block``s), labelling the
    collectives issued while each is the current one with its name."""
    global _SITE
    prev = _SITE
    try:
        for blk in blocks:
            _SITE = blk.name
            yield blk
    finally:
        _SITE = prev


def _caller() -> str:
    """The first function outside this module on the stack, as
    ``module.function``; "(backward)" is added when an autograd
    backward of this module issued the collective."""
    f, back = sys._getframe(2), False
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod == __name__:
            back = back or f.f_code.co_name == "backward"
        elif mod.startswith("repro_torch."):
            where = f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
            return where + (" (backward)" if back else "")
        f = f.f_back
    return "(backward)" if back else "?"


def _record(kind: str, t: torch.Tensor, group, parts: int) -> None:
    name = None
    if _MESH is not None:
        name = next((n for n in _MESH.mesh_dim_names
                     if _MESH.get_group(n) is group), None)
    where = _caller()
    _LOG.append({"kind": kind,
                 "bytes": t.numel() * t.element_size() * parts,
                 "dtype": str(t.dtype).replace("torch.", ""),
                 "group": name,
                 "ranks": tuple(dist.get_process_group_ranks(group)),
                 "site": where if _SITE is None else f"{where}/{_SITE}"})


def gather_except(dt: DTensor, keep: Sequence[str] = ()) -> torch.Tensor:
    """This rank's part of a DTensor, whole over every sharding mesh dim
    but those named in ``keep``: ``all_gather`` in the group of each
    gathered mesh dim, the minor one first, so the parts concatenate in
    the order ``local_region`` lays them out. A tensor dim sharded by a
    kept and a gathered mesh dim at once is refused (``leaf_spec`` gives
    every param dim one axis)."""
    local = dt.to_local()
    mesh = dt.device_mesh
    names = tuple(mesh.mesh_dim_names)
    kept = {p.dim for i, p in enumerate(dt.placements)
            if isinstance(p, Shard) and names[i] in keep}
    for i in reversed(range(mesh.ndim)):
        p = dt.placements[i]
        if (not isinstance(p, Shard) or mesh.size(i) == 1
                or names[i] in keep):
            continue
        if p.dim in kept:
            raise ValueError(f"dim {p.dim} is sharded by a kept and a "
                             f"gathered mesh dim: {dt.placements}")
        local = _all_gather(local, mesh.get_group(i), p.dim)
    return local


def full_tensor(dt: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (``gather_except``
    keeping nothing local)."""
    return gather_except(dt)


def part_of_gathered(t: torch.Tensor, dt: DTensor,
                     keep: Sequence[str] = ()) -> torch.Tensor:
    """The piece of ``t`` (shaped as ``gather_except(dt, keep)``) that
    this rank holds of ``dt``: a view."""
    names = tuple(dt.device_mesh.mesh_dim_names)
    off, shp = region_of(dt.shape, dt.device_mesh, dt.placements)
    kept = {p.dim for i, p in enumerate(dt.placements)
            if isinstance(p, Shard) and names[i] in keep}
    off = tuple(0 if d in kept else o for d, o in enumerate(off))
    return t[_slices(off, shp)]


def _dp_index(mesh: DeviceMesh, dp: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, their count) over the data-parallel mesh dims
    ``dp``, the first the major one: the order in which ``local_region``
    lays out a dim those dims shard."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in dp:
        i = names.index(a)
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n


def dp_rows(batch: int, mesh: DeviceMesh,
            dp: Sequence[str]) -> Tuple[int, int]:
    """[lo, hi) of the rows of a global batch that this rank computes: its
    index over the data-parallel mesh dims ``dp``, the first the major
    one."""
    idx, n = _dp_index(mesh, dp)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} "
                         f"data-parallel ranks")
    per = batch // n
    return idx * per, (idx + 1) * per


# ---------------------------------------------------------------------------
# Activation sharding context and the model-axis split
# ---------------------------------------------------------------------------

# collectives issued through this module, by kind
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                               "reduce_scatter": 0, "all_to_all": 0}

_ACTIVE: Optional[MeshAxes] = None
_MESH: Optional[DeviceMesh] = None


def active_axis_size(kind: str) -> int:
    """Size of the active context's axis ("tp"/"dp"/...), 1 if no context."""
    if _ACTIVE is None:
        return 1
    ax = getattr(_ACTIVE, kind, None)
    if ax is None:
        return 1
    ax_t = ax if isinstance(ax, tuple) else (ax,)
    return math.prod(_ACTIVE.size(a) for a in ax_t)


def active_axes() -> Optional[MeshAxes]:
    """The active context's ``MeshAxes``, ``None`` outside a context."""
    return _ACTIVE


@contextlib.contextmanager
def activation_sharding(axes: Optional[MeshAxes],
                        mesh: Optional[DeviceMesh] = None):
    """Run model code split over ``mesh`` as ``axes`` say. Without a
    ``mesh`` the context only answers ``active_axis_size`` and
    ``constrain``, as the reference's does while tracing."""
    global _ACTIVE, _MESH
    prev = _ACTIVE, _MESH
    _ACTIVE, _MESH = axes, mesh
    try:
        yield
    finally:
        _ACTIVE, _MESH = prev


def _groups(kind: str) -> List[Any]:
    """The process groups of the active mesh dims behind ``kind`` whose
    size is above 1, major first; none outside a context with a mesh."""
    if _ACTIVE is None or _MESH is None:
        return []
    ax = getattr(_ACTIVE, kind)
    ax_t = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
    return [_MESH.get_group(a) for a in ax_t if _ACTIVE.size(a) > 1]


def tp_group() -> Optional[Any]:
    """The tensor-parallel group, ``None`` outside a split context."""
    g = _groups("tp")
    return g[0] if g else None


def ep_group() -> Optional[Any]:
    """The expert-parallel group, ``None`` outside a split context."""
    g = _groups("ep")
    return g[0] if g else None


def tp_size() -> int:
    """How many tensor-parallel ranks split the forward in the active
    context with a mesh; 1 outside one."""
    g = tp_group()
    return 1 if g is None else dist.get_world_size(g)


def tp_rank() -> int:
    """This rank's index on the tensor-parallel axis, 0 outside one."""
    g = tp_group()
    return 0 if g is None else dist.get_rank(g)


def ep_rank() -> int:
    """This rank's index on the expert-parallel axis, 0 outside one."""
    g = ep_group()
    return 0 if g is None else dist.get_rank(g)


def constrain(x: Any, dims: Sequence[Optional[str]]) -> Spec:
    """The spec the reference's ``constrain`` gives an activation of
    ``x``'s shape (a tensor or a shape; the global one). dims entries:
    "dp"|"sp"|"tp"|"ep"|None. An axis of size 1, one already used, or
    one that does not divide the dim leaves it unsharded. Outside a
    context every entry is ``None``. No data moves: the caller reads
    from the spec whether it holds a local slice."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    axes = _ACTIVE
    if axes is None:
        return (None,) * len(dims)
    spec: list = []
    used: set = set()
    for i, d in enumerate(dims):
        ax = {"dp": axes.dp, "sp": axes.sp, "tp": axes.tp, "ep": axes.ep,
              None: None}[d]
        if ax is None:
            spec.append(None)
            continue
        ax_t = ax if isinstance(ax, tuple) else (ax,)
        total = math.prod(axes.size(a) for a in ax_t)
        if total == 1 or any(a in used for a in ax_t) or shape[i] % total:
            spec.append(None)
        else:
            spec.append(ax_t[0] if len(ax_t) == 1 else ax_t)
            used.update(ax_t)
    return tuple(spec)


def active_leaf_spec(dims: Tuple[Optional[str], ...],
                     shape: Tuple[int, ...]) -> Spec:
    """``leaf_spec`` under the active context; all ``None`` outside one."""
    if _ACTIVE is None:
        return (None,) * len(dims)
    return leaf_spec(dims, shape, _ACTIVE)


def local_shape(spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape one rank holds of a leaf laid out by ``spec`` under the
    active context."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axs = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // math.prod(_ACTIVE.size(a) for a in axs))
    return tuple(out)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) over ``groups`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` forward; this rank's slice
    of the gradient backward (every rank holds the same gradient of the
    whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _Formed(torch.autograd.Function):
    """``whole``, formed from ``x`` by an earlier run of the same forward,
    returned in place of what ``x`` would form again, with no collective;
    backward, ``x``'s gradient as that op gives it: this rank's slice
    along ``dim`` of a gather over ``group``, or, with no group, the
    gradient itself."""

    @staticmethod
    def forward(ctx, x, whole, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = None if group is None else dist.get_rank(group)
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, g):
        if ctx.rank is not None:
            g = g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n)
        return g, None, None, None


class _GatherSum(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` forward; backward, the
    ranks' gradients of the whole reduce-scattered: summed, and this
    rank's slice kept (each rank used a part of the whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` over ``group`` forward; the ranks'
    slices of the gradient all-gathered backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor every rank of
    ``group`` holds whole forward; the ranks' slices of the gradient
    all-gathered backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _all_to_all(x: torch.Tensor, group, send: List[int],
                recv: List[int]) -> torch.Tensor:
    """``dist.all_to_all_single`` over dim 0 of ``x``: ``send[s]`` rows
    to rank ``s`` of ``group``, ``recv[s]`` rows from it, in rank
    order."""
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
    COLLECTIVES["all_to_all"] += 1
    if _LOG is not None:
        _record("all_to_all", out, group, 1)
    return out


class _Relayout(torch.autograd.Function):
    """An all-to-all over ``group`` forward; the inverse exchange (the
    row counts swapped) backward."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return _all_to_all(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.recv, ctx.send), None, None, None


def relayout_halves(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's contiguous columns of a fused ``[..., 2·n]`` projection
    split over the tensor-parallel ranks (``leaf_spec``'s layout of
    Mamba's ``in_proj`` and the mLSTM's ``up_proj``) -> its channels
    ``[r·k, (r+1)·k)`` of each half, ``k = n / tp``: one all-to-all, the
    counterpart of the collective-permutes GSPMD emits at the
    reference's ``jnp.split``. Rank ``r``'s ``2k`` columns are the
    blocks ``2r`` and ``2r+1`` of width ``k``; block ``b`` belongs to
    rank ``b mod tp``, first half below ``tp``, second half from it, so
    each rank receives its first-half block from rank ``r // 2`` and
    its second-half block from rank ``(tp + r) // 2``, in that order.
    The backward is the inverse exchange. Called only in a split
    context."""
    g = _groups("tp")[0]
    tp, r = dist.get_world_size(g), dist.get_rank(g)
    k = y.shape[-1] // 2
    lead = y.shape[:-1]
    blocks = y.reshape(-1, 2, k).transpose(0, 1)        # [2, M, k]
    dest = [(2 * r + j) % tp for j in (0, 1)]
    if dest[1] < dest[0]:                               # rows in rank order
        blocks, dest = blocks.flip(0), dest[::-1]
    send, recv = [0] * tp, [0] * tp
    for s in dest:
        send[s] += 1
    recv[r // 2] += 1
    recv[(tp + r) // 2] += 1
    out = _Relayout.apply(blocks, g, send, recv)        # [2, M, k]
    return out[0].reshape(*lead, k), out[1].reshape(*lead, k)


def copy_to_tp(x: torch.Tensor, kind: str = "tp") -> torch.Tensor:
    """Enter a column-parallel region: ``x`` as it is, its gradient
    summed over the tensor-parallel ranks (each holds a part of it;
    ``kind`` "ep": over the expert-parallel ranks)."""
    groups = _groups(kind)
    return _CopyTo.apply(x, groups) if groups else x


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Leave a row-parallel region: the ranks' partial sums added up;
    the gradient, whole on every rank, passes as it is."""
    groups = _groups("tp")
    return _ReduceFrom.apply(x, groups) if groups else x


def gather_from_tp(x: torch.Tensor, dim: int, kind: str = "tp"
                   ) -> torch.Tensor:
    """The ranks' slices of a replicated result joined along ``dim``
    (``kind`` "ep" joins over the expert-parallel axis)."""
    groups = _groups(kind)
    return _GatherFrom.apply(x, groups[0], dim) if groups else x


def formed(x: torch.Tensor, whole: torch.Tensor, dim: int = 0,
           kind: Optional[str] = None) -> torch.Tensor:
    """``whole``, the value that ``gather_from_tp(x, dim, kind)`` (``x``
    itself where ``kind`` is None) gave an earlier run of the same
    forward, with that op's backward and no collective: a recompute
    reads a kept tensor so (``moe.Kept``)."""
    groups = _groups(kind) if kind is not None else []
    return _Formed.apply(x, whole, groups[0] if groups else None, dim)


def all_gather_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The tensor-parallel ranks' slices joined along ``dim``, where each
    rank goes on to use only a part of the whole (its gradient of the
    whole is partial): the backward reduce-scatters the ranks'
    gradients, summed, this rank's slice kept."""
    groups = _groups("tp")
    return _GatherSum.apply(x, groups[0], dim) if groups else x


def seq_split(x: Any) -> bool:
    """Whether the residual stream ``x`` ([B, S, d], a tensor or a shape;
    S the whole sequence) is split over the sequence between blocks in
    the active context with a mesh: ``constrain(x, ("dp", "sp", None))``
    gives the sequence dim an axis (``sp`` is set, of size above 1, and
    divides S), the reference's rule."""
    return bool(_groups("sp")) and constrain(
        x, ("dp", "sp", None))[1] is not None


def gather_from_sp(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Enter a column-parallel region from the rank's rows of a
    sequence-split stream: the rows all-gathered along ``dim``; the
    backward reduce-scatters the ranks' partial gradients of the whole
    (in place of ``copy_to_tp``'s all-reduce)."""
    groups = _groups("sp")
    return _GatherSum.apply(x, groups[0], dim) if groups else x


def reduce_scatter_to_sp(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Leave a row-parallel region onto the rank's rows of a
    sequence-split stream: the ranks' partial sums reduce-scattered along
    ``dim``; the backward all-gathers the rows' gradients (in place of
    ``reduce_from_tp``'s all-reduce)."""
    groups = _groups("sp")
    return _ReduceScatter.apply(x, groups[0], dim) if groups else x


def scatter_to_sp(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The rank's rows along ``dim`` of a tensor every rank holds whole
    (a block that ran whole, the embedded inputs); the backward
    all-gathers the rows' gradients."""
    groups = _groups("sp")
    return _Scatter.apply(x, groups[0], dim) if groups else x


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data-parallel ranks; the gradient passes unchanged
    (a function whose backward is the identity, not
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces): each rank's gradient then carries only its own rows'
    part, and the train step sums those parts over the data ranks once."""
    groups = _groups("dp")
    return _ReduceFrom.apply(x, groups) if groups else x


def dp_all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the data-parallel ranks, outside autograd."""
    groups = _groups("dp")
    return _all_reduce(x.detach(), groups, op) if groups else x


def tp_all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the tensor-parallel ranks, outside autograd."""
    groups = _groups("tp")
    return _all_reduce(x.detach(), groups, op) if groups else x


def dp_slice(n: int) -> Tuple[int, int]:
    """[lo, hi) of ``n`` batch rows that this rank computes in the active
    context with a mesh; all of them outside one."""
    if _MESH is None or _ACTIVE is None:
        return 0, n
    return dp_rows(n, _MESH, _ACTIVE.dp)


def dp_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data-parallel ranks' rows of ``x`` joined along ``dim`` in
    ``dp_slice`` order (the minor mesh dim first), outside autograd."""
    for g in reversed(_groups("dp")):
        x = _all_gather(x, g, dim)
    return x


def dp_size() -> int:
    """How many data-parallel ranks split the batch in the active
    context with a mesh; 1 outside one."""
    return math.prod(dist.get_world_size(g) for g in _groups("dp"))


# ---------------------------------------------------------------------------
# Context-parallel decode: a KV cache split over kvseq on the data ranks
# ---------------------------------------------------------------------------
# Where a serving batch does not divide the data axes (long_500k's batch of
# 1), ``leaf_spec`` gives the cache's ``kvseq`` dim the data axes instead
# of ``batch``: each data rank holds a slice of the slots, and the batch is
# replicated. The reference leaves the rest to XLA's partitioner; here the
# model reads the split from this module (``serving_batch`` is entered by
# ``Model.prefill`` and ``Model.decode_step``), each rank attends over its
# slice, and ``merge_attention`` combines the ranks' results.

_KVSEQ = False   # the serving call in progress splits its caches on kvseq
# the attribute by which a cache leaf carries its global slot count
_SLOTS = "_kvseq_slots"


def kvseq_split(batch: int) -> bool:
    """Whether a serving batch of ``batch`` rows splits the KV cache over
    ``kvseq`` in the active context with a mesh: ``leaf_spec``'s rule, the
    batch does not divide the data axes and they hold more than one
    rank."""
    n = dp_size()
    return n > 1 and batch % n != 0


@contextlib.contextmanager
def serving_batch(batch: int):
    """A serving call over a global batch of ``batch`` rows: inside it,
    ``kvseq_active`` says whether its attention caches are split over
    ``kvseq`` (``kvseq_split``)."""
    global _KVSEQ
    prev = _KVSEQ
    _KVSEQ = kvseq_split(batch)
    try:
        yield
    finally:
        _KVSEQ = prev


def kvseq_active() -> bool:
    """Whether the serving call in progress splits its caches on
    ``kvseq``."""
    return _KVSEQ


def kvseq_slice(T: int) -> Tuple[int, int]:
    """[lo, hi) of a cache's ``T`` global slots that this rank holds where
    the serving call in progress splits it over ``kvseq``: the data ranks
    in the order of ``leaf_spec``, ``region_of`` and ``dp_rows`` (over
    ``("pod", "data")`` the pod the major one). ``(0, T)`` outside such a
    call, and where the data ranks do not divide ``T``: ``leaf_spec``
    keeps such a cache whole on every data rank."""
    if not _KVSEQ:
        return 0, T
    idx, n = _dp_index(_MESH, _ACTIVE.dp)
    if T % n:
        return 0, T
    per = T // n
    return idx * per, (idx + 1) * per


def kvseq_mark(t: torch.Tensor, T: int) -> torch.Tensor:
    """Record on ``t``, this rank's tensor of a cache leaf, the leaf's
    global slot count ``T``, and return ``t``. Its local slot count alone
    cannot say how it is laid out: a cache held whole and a split one of
    as many local slots look alike. ``init_cache`` marks the caches it
    makes in a split call (so a prefill's caches carry their layout to
    the decode steps that follow), ``Model.decode_step`` the local
    tensors of DTensor caches, and ``kvseq_layer`` each layer's view."""
    setattr(t, _SLOTS, T)
    return t


def kvseq_layer(t: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked cache leaf, carrying the leaf's mark."""
    T = getattr(t, _SLOTS, None)
    return t[i] if T is None else kvseq_mark(t[i], T)


def kvseq_range(t: torch.Tensor) -> Optional[Tuple[int, int]]:
    """[lo, hi) of the global slots that ``t``, this rank's tensor of one
    layer's cache ([B, slots, ...]), holds where the serving call in
    progress splits it over ``kvseq``; None where the call reads it as
    without the split, every rank over every slot and no merge (so its
    attention counts once): outside such a call, and where the data ranks
    do not divide its global slots, which ``leaf_spec`` then keeps whole.
    The global slot count is the one marked on ``t`` (``kvseq_mark``);
    an unmarked tensor is taken for a slice of a split cache."""
    if not _KVSEQ:
        return None
    n = dp_size()
    T = getattr(t, _SLOTS, t.shape[1] * n)
    return None if T % n else kvseq_slice(T)


def merge_attention(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The data ranks' attention over their slices of a ``kvseq``-split
    cache merged into the attention over every slot: ``out`` [..., hd]
    normalised over this rank's slots, ``lse`` f32 [...] their
    log-sum-exp (-inf for an empty slice). ``m = all_reduce(MAX, lse)``,
    then one ``all_reduce(SUM)`` of ``[exp(lse - m) * out, exp(lse - m)]``
    concatenated, and the quotient, in f32. ``m`` is clamped to finite and
    the sum of weights (at least 1 where any slice holds a slot) to 1e-30,
    so a group whose every ``lse`` is -inf gives 0, not NaN (as in a
    ``fake`` world, whose collectives return the local values). Both
    collectives are counted and logged. Returns ``out``'s dtype."""
    groups = _groups("dp")
    if not groups:
        return out
    m = _all_reduce(lse, groups, dist.ReduceOp.MAX)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    s = _all_reduce(torch.cat([out.float() * w, w], dim=-1), groups)
    return (s[..., :-1] / s[..., -1:].clamp_min(1e-30)).to(out.dtype)


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
