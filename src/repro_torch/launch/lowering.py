"""Cell construction for the dry run: (arch x shape x mesh) -> one rank's
step and its inputs, then traced and analysed (port of
``repro/launch/lowering.py``).

The reference lowers and compiles a jitted, sharded computation for 256
or 512 TPU chips and reads XLA's cost, memory and collectives. The port
builds what one rank runs — the entry points a user calls
(``make_train_step(mesh=)``, ``Model.prefill``, ``Model.decode_step``
under ``activation_sharding(axes, mesh)``) on that rank's shards — in a
world of 256 or 512 ranks (``launch.mesh.fake_world``), runs it once on
``meta`` tensors, and reads the same fields from the trace
(``_trace_cell``). On ``device="cuda"`` the same cell holds the rank's
shards on the card, drawn from a seeded generator, and runs for real
(its collectives, on the ``fake`` backend, move no data).

A batch that the data axes do not divide (``long_500k``'s batch of 1)
is replicated on every data rank and the KV cache split over ``kvseq``
instead, as the reference lays it out: each data rank holds a slice of
the slots and the ranks merge their attention (the context-parallel
decode, ``Model.decode_step``); its merge's all-reduces are in the
cell's collectives. ``SkipCell`` is left to the cells that
``shape_applicable`` rules out. ``seq_shard`` splits the activations
over the sequence between blocks (``make_axes(mesh, seq_shard=True)``:
each model rank holds ``S / tp`` rows of the residual stream, the
blocks gather and reduce-scatter them); ``build_cell``'s default is the
reference's rule, on for the train and prefill cells of every arch
with no SSM and no xLSTM blocks, and the cell's row records it.

Nothing here touches a process group at import; callers (``dryrun.py``)
start the world first.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.launch import analysis
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, build_model
from repro_torch.sharding.specs import (activation_sharding, collective_log,
                                        make_axes, map_dims, mesh_placements,
                                        param_specs, region_of, wrap_local)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step, state_dims
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ArchConfig
    kind: str
    step: Callable[..., Any]       # the rank's step: step(*args)
    args: Tuple[Any, ...]          # its inputs, DTensor leaves of this
    arg_bytes: int                 # rank's shards, whose bytes these are
    alias_bytes: int               # inputs the step updates (state, cache)
    seq_shard: bool = False        # activations split over the sequence


class SkipCell(Exception):
    pass


def _with_depth(cfg: ArchConfig, k_groups: int) -> ArchConfig:
    """Same arch with the layer stack truncated to k scan groups (and the
    encoder scaled proportionally)."""
    _, n_groups = T.build_group(cfg)
    group_size = cfg.n_layers // n_groups
    changes: Dict[str, Any] = {"n_layers": k_groups * group_size}
    if cfg.encoder is not None:
        unit = max(1, cfg.encoder.n_layers // n_groups)
        changes["encoder"] = dataclasses.replace(
            cfg.encoder, n_layers=k_groups * unit)
    return dataclasses.replace(cfg, **changes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_bytes(specs: Any, tree: Any, mesh: DeviceMesh) -> int:
    """Bytes of this rank's shards of ``tree`` laid out by ``specs``."""
    leaves = []
    map_dims(lambda spec, t: leaves.append(math.prod(region_of(
        t.shape, mesh, mesh_placements(spec, mesh))[1]) * t.element_size()),
        specs, tree)
    return sum(leaves)


def _shard(specs: Any, tree: Any, mesh: DeviceMesh,
           make: Callable[[Tuple[int, ...], torch.Tensor], torch.Tensor]
           ) -> Any:
    """DTensor leaves holding this rank's shard of each (``meta``) leaf of
    ``tree`` laid out by ``specs``; ``make(shape, leaf)`` builds it."""
    def one(spec, t):
        pl = mesh_placements(spec, mesh)
        return wrap_local(make(region_of(t.shape, mesh, pl)[1], t), mesh, pl,
                          t.shape)
    return map_dims(one, specs, tree)


def _maker(device: torch.device, seed: int):
    """How a cell's shards are made on ``device``: shapes alone on
    ``meta``; on the card drawn from a seeded generator (float leaves
    N(0, 0.02), zeros for integers and for ``zero`` leaves)."""
    if device.type == "meta":
        return lambda shape, like, zero=False: torch.empty(
            shape, dtype=like.dtype, device=device)
    gen = torch.Generator(device).manual_seed(seed)

    def make(shape, like, zero=False):
        if zero or not like.is_floating_point():
            return torch.zeros(shape, dtype=like.dtype, device=device)
        return torch.randn(shape, generator=gen, device=device).mul_(
            0.02).to(like.dtype)
    return make


def _batch(model: Model, struct: Dict[str, torch.Tensor],
           device: torch.device, seed: int) -> Dict[str, torch.Tensor]:
    """The global batch every rank is called with (it takes its rows), of
    ``struct``'s ``meta`` shapes: those on ``meta``, token ids and inputs
    drawn on the card."""
    if device.type == "meta":
        return struct
    gen = torch.Generator(device).manual_seed(seed + 1)
    return {k: (torch.randint(0, model.cfg.vocab_size, t.shape,
                              generator=gen, device=device, dtype=t.dtype)
                if not t.is_floating_point() else
                torch.randn(t.shape, generator=gen, device=device)
                .mul_(0.02).to(t.dtype))
            for k, t in struct.items()}


def default_seq_shard(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """The reference's default: sequence sharding between blocks for the
    train and prefill of an arch with no SSM and no xLSTM blocks (the
    recurrences need the whole sequence on a rank; the port runs them
    whole under an explicit ``seq_shard=True``)."""
    return (shape.kind in ("prefill", "train")
            and cfg.ssm is None and cfg.xlstm is None)


def build_cell(arch: str, shape_name: str, mesh: DeviceMesh, *,
               remat: Union[bool, str] = True,
               fsdp: Optional[bool] = None,
               seq_shard: Optional[bool] = None,
               depth_groups: Optional[int] = None,
               device: Any = "meta", seed: int = 0) -> Cell:
    """One rank's train step, prefill or decode step of a cell, on its
    shards of the inputs: ``meta`` ones, or drawn on ``device`` ("cuda"
    or "cpu", as ``resolve_device`` takes them). ``seq_shard`` ``None``
    takes ``default_seq_shard``. ``remat`` is the train step's
    (``transformer.stack_forward``: ``True``, ``False`` or
    ``"save_moe"``), as the reference's ``build_cell`` takes it."""
    remat = T.remat_policy(remat)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    if depth_groups is not None:
        cfg = _with_depth(cfg, depth_groups)
    model = build_model(cfg)
    use_fsdp = cfg.use_fsdp if fsdp is None else fsdp
    if seq_shard is None:
        seq_shard = default_seq_shard(cfg, shape)
    axes = make_axes(mesh, use_fsdp=use_fsdp, seq_shard=seq_shard)
    B, S = shape.global_batch, shape.seq_len
    n_dp = math.prod(axes.size(a) for a in axes.dp)
    device = resolve_device(device)
    make = _maker(device, seed)

    def batch_args(batch):
        bdims = {k: v for k, v in model.batch_dims().items() if k in batch}
        return _local_bytes(param_specs(bdims, batch, axes), batch, mesh)

    if shape.kind == "train":
        params = model.abstract_params()
        st = {"params": params, "opt_state": adamw_init(params),
              "step": torch.zeros((), dtype=torch.int32, device="meta")}
        specs = param_specs(state_dims(model), st, axes)
        state = {k: _shard(specs[k], st[k], mesh, make if k != "opt_state"
                           else lambda s, t: make(s, t, True))
                 for k in st}
        state_bytes = _local_bytes(specs, st, mesh)
        batch = _batch(model, model.batch_struct(B, S), device, seed)
        step = make_train_step(model, AdamWConfig(), mesh=mesh, axes=axes,
                               remat=remat)
        return Cell(arch, shape, cfg, "train", step, (state, batch),
                    state_bytes + batch_args(batch), state_bytes, seq_shard)

    abstract = model.abstract_params()
    pspecs = param_specs(model.param_dims(), abstract, axes)
    params = _shard(pspecs, abstract, mesh, make)
    param_bytes = _local_bytes(pspecs, abstract, mesh)

    if shape.kind == "prefill":
        struct = model.batch_struct(B, S)
        struct.pop("targets")
        batch = _batch(model, struct, device, seed)

        def prefill_fn(params, batch):
            with activation_sharding(axes, mesh):
                return model.prefill(params, batch, cache_len=S)

        return Cell(arch, shape, cfg, "prefill", prefill_fn, (params, batch),
                    param_bytes + batch_args(batch), 0, seq_shard)

    # decode: one new token against a cache of size seq_len, at its last
    # slot (the whole context)
    abstract_cache = model.init_cache(B, S, device="meta")
    cspecs = model.cache_specs(abstract_cache, axes)
    cache = _shard(cspecs, abstract_cache, mesh,
                   lambda s, t: make(s, t, True))
    cache_bytes = _local_bytes(cspecs, abstract_cache, mesh)
    token = _batch(model, {"tokens": torch.empty(
        (B, 1), dtype=torch.int32, device="meta")}, device, seed)["tokens"]

    def serve_step(params, cache, token, pos):
        with activation_sharding(axes, mesh):
            return model.decode_step(params, cache, token, pos)

    # the token's rows (the whole token where the batch does not divide
    # the data axes: it is replicated), and pos as the reference's int32
    # scalar
    rows = 1 if B % n_dp else n_dp
    arg_bytes = param_bytes + cache_bytes + _nbytes(token) // rows + 4
    return Cell(arch, shape, cfg, "decode", serve_step,
                (params, cache, token, S - 1), arg_bytes, cache_bytes,
                seq_shard)


def _trace_cell(cell: Cell, track_memory: bool = True) -> Dict[str, Any]:
    """Run the cell's step once on its ``meta`` inputs under
    ``FlopCounterMode``, ``analysis.TraceCounter`` and the collective
    log: the trace's time, cost, memory, collectives, fused bytes and the
    kernels' calls (what the card would launch)."""
    build.META_CALLS.clear()
    flops = FlopCounterMode(display=False)
    counter = analysis.TraceCounter(track_memory)
    with collective_log() as log:
        t0 = time.monotonic()
        with flops, counter:
            out = cell.step(*cell.args)
        trace_s = time.monotonic() - t0
    out_bytes = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                    for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    del out
    kernels = {k: {"calls": c, "flops": f, "bytes": b}
               for k, (c, f, b) in build.META_CALLS.items()}
    k_flops = sum(k["flops"] for k in kernels.values())
    k_bytes = sum(k["bytes"] for k in kernels.values())
    res = {
        "trace_s": round(trace_s, 2),
        "cost": {"flops": float(flops.get_total_flops() + k_flops),
                 "bytes accessed": float(counter.bytes + k_bytes)},
        "collectives": analysis.collective_bytes(log),
        "fused": analysis.fused_memory_bytes(counter, log, k_bytes),
        "left_out": dict(counter.left_out),
        "kernels": kernels,
        "log": log,
    }
    if track_memory:
        res["memory_analysis"] = {
            "argument_size_in_bytes": cell.arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": cell.alias_bytes,
            "temp_size_in_bytes": counter.peak}
    return res


def lower_and_analyze(cell_args: Dict[str, Any], mesh: DeviceMesh,
                      *, full_compile: bool = True) -> Dict[str, Any]:
    """Full analysis of one (arch x shape x mesh) cell, with the
    reference's keys: this rank's step traced once at full depth on
    ``meta`` tensors. The reference compiles depth-1 and depth-2 cells
    too, because XLA's ``cost_analysis`` counts a ``scan`` body once and
    the per-step cost must be extrapolated; the port's stacks are Python
    loops, whose trace counts every layer, so the full-depth trace is
    the cost, and there is no ``extrapolation`` (nor ``collectives_raw``,
    which would equal ``collectives``). ``trace_s`` stands where the
    reference has ``lower_s`` and ``compile_s``. Without
    ``full_compile`` the trace skips the live-bytes tracker and the
    result has no ``memory_analysis``, as the reference's quick mode."""
    arch, shape_name = cell_args["arch"], cell_args["shape"]
    bkw = {k: v for k, v in cell_args.items() if k not in ("arch", "shape")}
    n_chips = mesh.size()
    cfg_full = get_config(arch)
    _, n_groups = T.build_group(cfg_full)
    out: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_chips": n_chips,
        "params": cfg_full.param_count(),
        "active_params": cfg_full.active_param_count(),
        "n_groups": n_groups,
    }
    cell = build_cell(arch, shape_name, mesh, **bkw)
    out["kind"] = cell.kind
    out["seq_shard"] = cell.seq_shard
    res = _trace_cell(cell, track_memory=full_compile)
    out["trace_s"] = res["trace_s"]
    if full_compile:
        out["memory_analysis"] = res["memory_analysis"]
    roof = analysis.roofline(res["cost"], res["collectives"], cell.cfg,
                             cell.shape, n_chips, fused=res["fused"])
    out.update({
        "flops_per_device": res["cost"]["flops"],
        "bytes_per_device": res["cost"]["bytes accessed"],
        "collectives": res["collectives"],
        "kernel_calls": {k: v["calls"] for k, v in res["kernels"].items()},
        "roofline": roof,
    })
    return out
