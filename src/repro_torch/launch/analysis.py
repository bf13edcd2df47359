"""Roofline accounting of a traced dry-run cell, at NVIDIA H100 constants
(port of ``repro/launch/analysis.py``).

Three terms per (arch x shape x mesh):
  compute    = FLOPs per rank / peak FLOP/s of one GPU
  memory     = bytes per rank / HBM bandwidth
  collective = the link bytes of each collective / the rate of the link
               its group crosses (NVLink inside a node, InfiniBand across)

The reference reads XLA's ``cost_analysis`` and parses the optimized HLO
for its collectives. Torch has neither a whole-program compiler analysis
nor HLO, so the port reads the same fields from one rank's step traced
on ``meta`` tensors (``launch.lowering``): FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` plus the kernels' own
(``kernels.build.META_CALLS``: a kernel wrapper on ``meta`` tensors
records its launch instead of running), bytes from ``TraceCounter``'s
dispatch-level count, and the collectives from
``sharding.specs.collective_log``. Every number is per rank, after the
split, as XLA's post-SPMD program is per device.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import ArchConfig, ShapeConfig

# NVIDIA H100 SXM5, one GPU (NVIDIA H100 Tensor Core GPU data sheet):
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (1,979e12 sparse)
HBM_BW = 3.35e12             # HBM3 bytes/s
# NVLink 4: 900 GB/s per GPU both directions together (data sheet), so
# 450e9 bytes/s each way, for a group inside one 8-GPU HGX H100 node
NVLINK_BW = 450e9
# across nodes: one 400 Gb/s NDR InfiniBand ConnectX-7 adapter per GPU
# (the DGX H100 layout, NVIDIA DGX H100 data sheet): 50e9 bytes/s
IB_BW = 50e9
NODE_GPUS = 8                # ranks r, s share a node when r // 8 == s // 8

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def crosses_nodes(ranks: Sequence[int]) -> bool:
    """Whether a group's ranks sit in more than one 8-GPU node."""
    return len({r // NODE_GPUS for r in ranks}) > 1


def collective_bytes(records: Sequence[Dict[str, Any]]) -> Dict[str, int]:
    """Per-rank bytes moved by each collective type (+ op counts), from
    ``specs.collective_log()`` records.

    ``total_link_bytes`` weights all-reduce x2 (a ring all-reduce moves
    ~2x the buffer: a reduce-scatter and an all-gather phase), the others
    x1, as the reference's does (a reduce-scatter's record is the shard
    it leaves, the reference's result buffer); ``nvlink_link_bytes`` and
    ``ib_link_bytes`` split it by whether the group stays in one node.
    The reference also halves bf16 all-reduces that XLA:CPU promotes to
    f32 (``clone_promoted``); torch reduces a tensor at its own dtype, so
    a record's bytes are already the link's and nothing is adjusted.
    """
    out: Dict[str, int] = {f"{op}_bytes": 0 for op in _COLL_OPS}
    counts: Dict[str, int] = {f"{op}_count": 0 for op in _COLL_OPS}
    link = {"nvlink": 0, "ib": 0}
    for r in records:
        op = _KIND[r["kind"]]
        n = int(r["bytes"])
        out[f"{op}_bytes"] += n
        counts[f"{op}_count"] += 1
        link["ib" if crosses_nodes(r["ranks"]) else "nvlink"] += \
            2 * n if op == "all-reduce" else n
    total = sum(out.values())
    return {**out, **counts, "total_bytes": total,
            "total_link_bytes": total + out["all-reduce_bytes"],
            "nvlink_link_bytes": link["nvlink"], "ib_link_bytes": link["ib"]}


def top_collectives(records: Sequence[Dict[str, Any]], k: int = 15
                    ) -> List[Tuple[int, str, str, int]]:
    """The k largest collectives by the bytes they move in all, as
    (bytes, op, call site, count): one row per (op, site, buffer size),
    since a traced loop issues the same collective once a layer — the
    dry-run 'profile'."""
    rows: Dict[Tuple[str, str, int], int] = defaultdict(int)
    for r in records:
        rows[(_KIND[r["kind"]], r["site"], int(r["bytes"]))] += 1
    items = [(b * c, op, where, c) for (op, where, b), c in rows.items()]
    items.sort(reverse=True)
    return items[:k]


def link_bytes_by_site(records: Sequence[Dict[str, Any]]
                       ) -> List[Tuple[str, int]]:
    """Each call site's link bytes (``collective_bytes``'s
    ``total_link_bytes`` over its records; the site without its block
    label), largest first."""
    sites: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for r in records:
        sites[r["site"].split("/")[0]].append(r)
    rows = [(w, collective_bytes(rs)["total_link_bytes"])
            for w, rs in sites.items()]
    return sorted(rows, key=lambda r: -r[1])


# ---------------------------------------------------------------------------
# The dispatch-level byte count and live-memory tracker
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that force a fusion boundary on a GPU as on a TPU: matmuls, gathers
# and scatters, sorts (the reference's dot, gather, scatter, sort); the
# collectives are counted from their records
_HEAVY = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
          _aten.baddbmm.default, _aten.convolution.default,
          _aten.convolution_backward.default, _aten.embedding.default,
          _aten.embedding_dense_backward.default,
          _aten.index_select.default, _aten.gather.default,
          _aten.scatter.src, _aten.scatter.value, _aten.scatter_add.default,
          _aten.index_add.default, _aten.index.Tensor, _aten.sort.default,
          _aten.sort.stable, _aten.topk.default}
# the batched products, where attention forms its scores
_SCORE_MATMULS = {_aten.bmm.default, _aten.baddbmm.default}
# index and slice updates, in place on the card: their traffic is the
# update alone (the argument at this position); copy_ counts only as a
# write into a view of a larger buffer (a cache slot)
_UPDATES = {_aten.index_put.default: 2, _aten.index_put_.default: 2,
            _aten._index_put_impl_.default: 2,
            _aten.slice_scatter.default: 1, _aten.select_scatter.default: 1,
            _aten.index_copy.default: 3, _aten.index_copy_.default: 3,
            _aten.copy_.default: 1}
# ops that read no tensor data (shapes, strides, allocation)
_METADATA = {"aten::empty", "aten::empty_like", "aten::empty_strided",
             "aten::new_empty", "aten::new_empty_strided", "aten::detach",
             "aten::lift_fresh", "aten::_local_scalar_dense",
             "aten::is_same_size"}
# bytes a CUDA caching-allocator block is rounded to
_ALLOC_ROUND = 512


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)
            and not isinstance(t, DTensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts, over every aten op dispatched inside it:

      * ``bytes``: each op's input and output bytes (an in-place op's
        inputs), views and metadata ops left out (XLA's unfused "bytes
        accessed");
      * ``fused_bytes``: the same over the fusion-boundary ops only
        (matmuls, gathers, scatters, sorts), an index or slice update
        counted at its update alone; elementwise chains fuse;
      * ``flash_bytes``: ``fused_bytes`` without the attention scores, as
        a flash kernel keeps them on chip. A score is the output of a
        batched matmul (``bmm``: q.k^T is one over batch x heads, as
        every ``einsum`` of the port's attention dispatches it) more
        than 4x its inputs ([B*H, S, T] from [B*H, S, hd] and [B*H, hd,
        T]; d(p) = do.v^T the same in the backward), and what an op
        derives from one at its size (mask, exp, softmax, their
        backward). A 2-D product is a projection, never a score: a
        row-parallel ``wo`` of one q head a rank ([N, hd] @ [hd, d])
        grows its inputs as much. This stands in for the reference's
        trailing-dims rule, which the port's dispatch shapes (scores as
        [B*H, S, T] matmul outputs, query chunks) do not meet;
      * ``left_out``: the bytes ``flash_bytes`` leaves out, by the shape
        of the score tensor they belong to;
      * ``peak``: with ``track_memory``, the most bytes of storage made
        inside it and alive at once (each block rounded to 512 bytes, as
        the CUDA caching allocator rounds), each counted until its
        storage is freed; tensors made before it are not counted.
    """

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.track_memory = track_memory
        self.bytes = 0
        self.fused_bytes = 0
        self.flash_bytes = 0
        self.live = 0
        self.peak = 0
        self._owned: Dict[int, int] = {}
        self._scores: set = set()
        self.left_out: Dict[Tuple[int, ...], int] = defaultdict(int)

    def _key(self, t: torch.Tensor) -> int:
        return id(t.untyped_storage())

    def _is_score(self, t: torch.Tensor) -> bool:
        return self._key(t) in self._scores

    def _tag_score(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) not in self._scores:
            self._scores.add(id(st))
            weakref.finalize(st, self._scores.discard, id(st))

    def _moved(self, ts: Sequence[torch.Tensor]) -> None:
        n = sum(map(_nbytes, ts))
        self.fused_bytes += n
        self.flash_bytes += n
        for t in ts:
            if self._is_score(t):
                self.flash_bytes -= _nbytes(t)
                self.left_out[tuple(t.shape)] += _nbytes(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        mutable = func._schema.is_mutable
        if self.track_memory and not mutable:
            # an output on an input's storage (_unsafe_view, lift_fresh)
            # allocates nothing
            held = {self._key(t) for t in ins}
            for t in outs:
                if self._key(t) not in held:
                    self._track(t)
        if func._schema.name in _METADATA:
            return out
        self.bytes += sum(map(_nbytes, ins)) + (0 if mutable else
                                                sum(map(_nbytes, outs)))
        if func in _UPDATES:
            if func is not _aten.copy_.default or args[0]._base is not None:
                self._moved([args[_UPDATES[func]]])
        elif func in _HEAVY:
            if func in _SCORE_MATMULS and _nbytes(outs[0]) > 4 * sum(
                    _nbytes(t) for t in ins[-2:]):
                self._tag_score(outs[0])
            self._moved(ins + outs)
        elif outs and any(self._is_score(t) for t in ins):
            n = max(t.numel() for t in ins if self._is_score(t))
            for t in outs:
                if t.numel() == n:
                    self._tag_score(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._owned:
            return
        n = -(-st.nbytes() // _ALLOC_ROUND) * _ALLOC_ROUND
        self._owned[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)


def fused_memory_bytes(counter: TraceCounter,
                       records: Sequence[Dict[str, Any]],
                       kernel_bytes: int = 0) -> Dict[str, float]:
    """GPU-fusion-adjusted HBM traffic of a traced step (the reference's
    keys): ``fused_bytes`` counts the fusion-boundary ops of ``counter``,
    the attention kernels' own bytes (``kernel_bytes``, from
    ``build.META_CALLS``) and each collective's buffers (an all-reduce
    and an all-to-all read and write their buffer, an all-gather reads
    its part and writes the whole, a reduce-scatter reads the whole and
    writes its shard); ``fused_flash_bytes`` the same without the score
    tensors that ``attention_ref`` and ``headdim_attention`` form."""
    coll = 0
    for r in records:
        n, kind = int(r["bytes"]), r["kind"]
        if kind == "all_gather":
            coll += n + n // len(r["ranks"])
        elif kind == "reduce_scatter":
            coll += n * len(r["ranks"]) + n
        else:
            coll += 2 * n
    return {"fused_bytes": float(counter.fused_bytes + kernel_bytes + coll),
            "fused_flash_bytes": float(counter.flash_bytes + kernel_bytes
                                       + coll)}


# ---------------------------------------------------------------------------
# Model FLOPs and the roofline
# ---------------------------------------------------------------------------

def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D (train) or 2·N_active·D
    (prefill/decode) + attention context terms."""
    N = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    # attention layers and their effective context
    n_attn, eff_ctx = 0, 0.0
    from repro_torch.models.transformer import build_group
    blocks, n_groups = build_group(cfg)
    for blk in blocks:
        if blk.kind == "attn":
            w = blk.spec.window
            ctx = min(S, w) if w else S
            n_attn += n_groups
            eff_ctx += n_groups * ctx
    H, hd = cfg.n_heads, cfg.head_dim
    if shape.kind == "train":
        D = B * S
        dense = 6.0 * N * D
        attn = 6.0 * B * S * eff_ctx * H * hd    # causal fwd+bwd (12*0.5)
        return dense + attn
    if shape.kind == "prefill":
        D = B * S
        return 2.0 * N * D + 2.0 * B * S * eff_ctx * H * hd
    # decode: one token over a full context
    return 2.0 * N * B + 4.0 * B * eff_ctx * H * hd


def collective_seconds(coll: Dict[str, int]) -> float:
    """The collectives' link time: NVLink bytes at ``NVLINK_BW``, bytes
    of groups that cross nodes at ``IB_BW``; a count without the split
    is taken as crossing nodes."""
    if "nvlink_link_bytes" in coll or "ib_link_bytes" in coll:
        return (coll.get("nvlink_link_bytes", 0) / NVLINK_BW
                + coll.get("ib_link_bytes", 0) / IB_BW)
    return float(coll.get("total_link_bytes", coll["total_bytes"])) / IB_BW


def roofline(cost: Dict[str, float], coll: Dict[str, int],
             cfg: ArchConfig, shape: ShapeConfig,
             n_chips: int,
             fused: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = collective_seconds(coll)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * n_chips
    out = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": max(terms, key=terms.get),
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": (mf / hlo_global) if hlo_global else 0.0,
        "step_bound_s": max(terms.values()),
        # fraction of roofline: useful work per second at the bound vs peak
        "roofline_fraction": (
            (mf / n_chips / PEAK_FLOPS) / max(terms.values())
            if max(terms.values()) > 0 else 0.0),
    }
    if fused is not None:
        # fusion-adjusted memory terms (see fused_memory_bytes):
        #   fused  — elementwise chains fuse; matmuls/gathers/collectives move
        #   flash  — additionally, attention scores stay on chip (the flash
        #            and decode kernels' contribution)
        t_mf = fused["fused_bytes"] / HBM_BW
        t_mfl = fused["fused_flash_bytes"] / HBM_BW
        terms_f = {"compute": t_compute, "memory": t_mfl,
                   "collective": t_coll}
        out.update({
            "memory_fused_s": t_mf,
            "memory_flash_s": t_mfl,
            "dominant_flash": max(terms_f, key=terms_f.get),
            "step_bound_flash_s": max(terms_f.values()),
            "roofline_fraction_flash": (
                (mf / n_chips / PEAK_FLOPS) / max(terms_f.values())
                if max(terms_f.values()) > 0 else 0.0),
        })
    return out
