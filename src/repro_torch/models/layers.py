"""Core model layers: norms, RoPE, GQA attention, MLP variants.

Port of ``repro/models/layers.py``. Parameters are plain dicts of
tensors, named and laid out as in the reference, so a JAX init converts
one to one (``repro_torch.convert``). Training attention is the plain
reference path (``attention_ref``) with its autograd, as the reference's
(the TPU flash kernel has no backward), except self-attention on the card
in bf16 at head dim 64 or 128, which runs the flash forward and its
hand-written backward (``_attend``). Serving goes through the hand-written
kernels of ``kernels.ops``: prefill through flash_attention, decode
through decode_attention, over a cache updated in place. Cross-attention
(enc-dec) serves through the same two kernels over the encoder memory
``mk``/``mv``: non-causal flash in prefill, decode at ``pos = T_enc - 1``
(every slot visible) in each step. Each builder
also records the *logical dims* of every leaf (e.g.
``("embed", "q_dim")``) in a parallel dict, as the reference does.

Under ``sharding.specs.activation_sharding(axes, mesh)`` with a model
axis, every function here takes this rank's slices of the params (laid
out by ``leaf_spec``) and splits its work as GSPMD splits the
reference's: ``wq``/``wk``/``wv`` column-parallel over the rank's heads
and ``wo`` row-parallel, ``wg``/``wu`` column- and ``wd`` row-parallel
over ``ff``, one ``reduce_from_tp`` a block; the embedding and the
unembedding vocab-parallel. KV projections whose head count the model
axis does not divide stay whole on every rank, and each rank takes the
kv heads its q heads read (``HeadSplit``). Prefill and decode run the
same kernels on the rank's heads. Where the axis does not divide the q
heads but divides head_dim (llama4's 40 heads over 16 ranks),
``leaf_spec`` splits ``wq`` and ``wo`` over head_dim, as the
reference's attention constrains q, k and v: each rank projects every
q head's slice of head_dim (rotated whole, its slice kept), takes the
same slice of the whole k and v, and ``headdim_attention`` all-reduces
the partial q.k scores (in the compute dtype, as the reference forms
them) before an f32 softmax over whole heads, p.v on
the slice, ``wo`` row-parallel with the block's one all-reduce; the
train forward and backward, prefill and decode
(``HEADDIM_TP_CALLS``). A KV cache split over ``head_dim`` (kv heads
that do not divide the axis) decodes through the same function, since
the kernels take the softmax over a whole head. Where the axis divides neither, ``wq`` is whole and the
layer runs whole on every rank.

The context-parallel decode. Where the serving batch does not divide the
data axes (``specs.kvseq_active``), each data rank holds a slice of the
KV cache's slots (and of the cross-attention memory's): the token's k
and v go only to the rank that holds ``pos``, each rank attends over its
slots up to ``pos`` through the reader its layout takes, each returning
the rows' log-sum-exp beside the output (the decode kernel,
``attention_ref`` for a windowed layer, ``headdim_decode_attention`` for
a head_dim-split cache), and ``specs.merge_attention`` combines the
ranks' results (``_cp_decode``).

Sequence sharding (``specs.seq_split``; the reference's ``seq_shard``).
A training or prefill stream whose sequence divides over the model axis
comes to each block as this rank's ``S / tp`` rows, and a function
called with ``sp=True`` takes it so, Megatron style: the pre-norm runs
on the rows, its weight entered with ``copy_to_tp`` (each rank sees a
part of the rows, so the weight's gradient is summed), the normed rows
are gathered with ``gather_from_sp`` in place of ``copy_to_tp``,
attention (RoPE on whole positions, the KV caches whole over the
sequence) and the MLP run on the whole rows of the rank's heads and
``ff`` columns, and ``reduce_scatter_to_sp`` leaves the block in place
of ``reduce_from_tp``. A layer that runs whole on every rank (no head
split, or an MLP whose ``ff`` is not split) runs through
``whole_rows``: ``gather_from_tp`` in, ``scatter_to_sp`` out. The
vocab-parallel embedding reduce-scatters its lookup over the sequence,
and the unembedding gathers the rows with ``gather_from_sp``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.obs.telemetry import registry
from repro_torch.sharding import specs as SH

Params = Any
Dims = Any
# the registry counter of decode calls of windowed layers, which run
# attention_ref (no kernel)
WINDOW_REF_DECODES = "attn.window_ref_decodes"
# the decode kernel's launches, counted by its module
DECODE_LAUNCHES = (DA.LAUNCHES, "decode_attention")
# the registry counter of calls of headdim_attention (train forward and
# its recompute, prefill, decode, and decode over a KV cache split on
# head_dim): attention over a head_dim split, in plain torch
HEADDIM_TP_CALLS = "attn.headdim_plain"


class ParamBuilder:
    """Collects (param, logical-dims) pairs, drawing from one generator.

    Same distributions and scales as the reference; ``jax.random`` bits
    cannot be replayed in torch, so the values differ for the same seed.
    Values are drawn in f32 on the generator's own device, then cast and
    moved to ``device``: a CPU generator gives the same init on every
    device, and a generator on the card draws a full-width model there,
    as the reference draws on its device. On the ``meta`` device nothing
    is drawn or allocated: the builder then records shapes, dtypes and
    dims alone (``jax.eval_shape``'s counterpart).
    """

    def __init__(self, gen: torch.Generator, dtype: torch.dtype,
                 device: Any):
        self._gen = gen
        self.dtype = dtype
        self.device = device
        self.params: Dict[str, Any] = {}
        self.dims: Dict[str, Any] = {}

    def add(self, name: str, shape: Tuple[int, ...], dims: Tuple[Optional[str], ...],
            init: str = "normal", scale: Optional[float] = None) -> None:
        assert len(shape) == len(dims), (name, shape, dims)
        if torch.device(self.device).type == "meta":
            p = torch.empty(shape, dtype=self.dtype, device="meta")
        elif init == "zeros":
            p = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            p = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "log_arange":          # log(1..n) along the last dim
            p = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=self.device)).expand(
                shape).to(self.dtype)
        else:
            if scale is None:
                fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
                scale = 1.0 / math.sqrt(fan_in)
            p = torch.randn(shape, generator=self._gen,
                            device=self._gen.device,
                            dtype=torch.float32).mul_(scale).to(self.dtype)
        self.params[name] = p.to(self.device)
        self.dims[name] = dims

    def sub(self, name: str, builder_fn) -> None:
        b = ParamBuilder(self._gen, self.dtype, self.device)
        builder_fn(b)
        self.params[name] = b.params
        self.dims[name] = b.dims

    def build(self) -> Tuple[Params, Dims]:
        return self.params, self.dims


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class _RMSNorm(torch.autograd.Function):
    """RMSNorm, dtype-preserving in BOTH directions (the reference's
    custom VJP): [..., d] tangents stay in the compute dtype; only the row
    reductions run in f32."""

    @staticmethod
    def forward(ctx, x, w, eps):
        var = x.square().float().mean(dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps)                        # f32 [..., 1]
        ctx.save_for_backward(x, w, r)
        return x * r.to(x.dtype) * w

    @staticmethod
    def backward(ctx, dy):
        x, w, r = ctx.saved_tensors
        dt = x.dtype
        d = x.shape[-1]
        s = dy * w                                        # compute dtype
        dot = (x * s).float().sum(dim=-1, keepdim=True)   # f32 [..., 1]
        coef = (r ** 3 * dot / d).to(dt)                  # [..., 1]
        dx = s * r.to(dt) - x * coef
        dw_full = dy * x * r.to(dt)
        dw = dw_full.reshape(-1, d).float().sum(dim=0).to(w.dtype)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _RMSNorm.apply(x, w, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device: Any = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).

    Angles are computed in f32 (tiny [S,hd/2] tables); the rotation itself
    runs in the compute dtype — no full-tensor f32 round-trip.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., :, None, None].float() * freqs
    cos = torch.cos(angles).to(x.dtype)                     # [...,S,1,hd/2]
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# Attention (reference path). Grouped-query form: KV heads are never
# materialized q_per_kv times.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  return_lse: bool = False,
                  scale: Optional[float] = None):
    """q: [B,S,Hq,hd]; k,v: [B,T,Hkv,hd] -> [B,S,Hq,hd]. The scores are
    scaled by ``scale`` (default 1/sqrt(hd)).

    ``window`` (if set) restricts attention to the last ``window`` keys
    relative to each query (sliding-window / local attention). With
    ``return_lse`` (a context-parallel decode's slice of a cache): (out,
    lse f32 [B,S,Hq]), each row's log-sum-exp of its scaled scores over
    the keys it sees; a row that sees none gives 0 and -inf.
    """
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    # scores stay in the compute dtype; softmax reductions accumulate f32
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    scores = scores / math.sqrt(hd) if scale is None else scores * scale

    if q_positions is None:
        q_positions = torch.arange(S, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=q.device)
    rel = q_positions[:, None] - kv_positions[None, :]       # [S,T]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    # the constants as Python scalars, taken in the scores' dtype: no copy
    # from the host, which a step captured in a CUDA graph cannot make
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(scores - m)                                # compute dtype
    denom = p.float().sum(dim=-1, keepdim=True).to(p.dtype)
    probs = p / torch.clamp_min(denom, 1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    out = out.reshape(B, S, Hq, hd)
    if not return_lse:
        return out
    live = mask.any(dim=-1)                                  # [S]
    lse = (m.float() + torch.log(p.float().sum(dim=-1, keepdim=True)))[..., 0]
    lse = lse.permute(0, 3, 1, 2).reshape(B, S, Hq)
    return (torch.where(live[None, :, None, None], out, 0.0).to(out.dtype),
            torch.where(live[None, :, None], lse, -math.inf))


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float
    norm_eps: float
    window: Optional[int] = None        # sliding window, None = full
    causal: bool = True
    cross: bool = False                 # cross-attention (enc-dec)
    use_rope: bool = True
    scale: Optional[float] = None       # score scale; None: 1/sqrt(head_dim)
    res_mult: float = 1.0               # the output's factor before its add


def attn_init(b: ParamBuilder, spec: AttnSpec) -> None:
    d, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    b.add("norm", (d,), ("embed_nt",), init="ones")
    b.add("wq", (d, H, hd), ("embed", "heads", "head_dim"))
    b.add("wk", (d, Hkv, hd), ("embed", "kv_heads", "head_dim"))
    b.add("wv", (d, Hkv, hd), ("embed", "kv_heads", "head_dim"))
    b.add("wo", (H, hd, d), ("heads", "head_dim", "embed"),
          scale=1.0 / math.sqrt(H * hd))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,d] @ [d,H,hd] -> [B,S,H,hd]."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(
        -1, w.shape[1:])


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,H,hd] @ [H,hd,d] -> [B,S,d]."""
    return torch.matmul(o.flatten(-2), w.reshape(-1, w.shape[-1]))


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How one rank of the tensor-parallel axis holds an attention layer.

    ``q0``/``nq``: its q heads (``wq``'s and ``wo``'s slices). ``kv0``/
    ``nkv``: the kv heads those read. ``kv_sharded``: ``wk``/``wv`` hold
    only this rank's kv heads; otherwise they are whole (``leaf_spec``
    replicates KV projections whose heads the axis does not divide) and
    their gradient is summed over the ranks. ``cache``: the KV cache's
    layout, "heads" (the rank's kv heads), "head_dim" (every kv head, the
    rank's slice of head_dim) or "whole". ``q_dim``: the axis does not
    divide the q heads but divides head_dim, so ``wq`` and ``wo`` hold
    every q head's slice of head_dim (``q0`` 0, ``nq`` all of them), the
    KV projections are whole and the cache is "head_dim".
    """
    tp: int
    rank: int
    q0: int
    nq: int
    kv0: int
    nkv: int
    kv_sharded: bool
    cache: str
    q_dim: bool = False


def head_split(spec: AttnSpec) -> Optional[HeadSplit]:
    """This rank's share of an attention layer; ``None`` outside a split
    context, and where the model axis divides neither the q heads nor
    head_dim (``wq`` is then whole, and the layer runs whole on every
    rank, as the reference's replicated ``wq`` does)."""
    tp = SH.tp_size()
    if tp == 1:
        return None
    d, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    tp_ax = SH.active_axes().tp
    wq = SH.active_leaf_spec(("embed", "heads", "head_dim"), (d, H, hd))
    kv_sharded = SH.active_leaf_spec(("embed", "kv_heads", "head_dim"),
                                     (d, Hkv, hd))[1] == tp_ax
    cspec = SH.active_leaf_spec(
        ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
        (1, 1, 1, Hkv, hd))
    cache = ("heads" if cspec[3] == tp_ax else
             "head_dim" if cspec[4] == tp_ax else "whole")
    r = SH.tp_rank()
    if wq[1] != tp_ax:
        if wq[2] != tp_ax:
            return None
        return HeadSplit(tp, r, 0, H, 0, Hkv, False, cache, q_dim=True)
    nq, g = H // tp, H // Hkv
    if kv_sharded:
        nkv = Hkv // tp
        kv0 = r * nkv
    elif nq % g and g % nq:
        raise ValueError(f"{nq} q heads a rank do not cover whole groups "
                         f"of {g} q heads a kv head")
    else:
        kv0, nkv = r * nq // g, max(1, nq // g)
    return HeadSplit(tp, r, r * nq, nq, kv0, nkv, kv_sharded, cache)


def _kv_weights(p: Params, hs: Optional[HeadSplit]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wk``, ``wv`` as the projection uses them: a whole KV projection
    of a split layer gets its gradient summed over the ranks."""
    wk, wv = p["wk"], p["wv"]
    if hs is not None and not hs.kv_sharded:
        wk, wv = SH.copy_to_tp(wk), SH.copy_to_tp(wv)
    return wk, wv


def _dim_slice(hs: HeadSplit, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t``'s last dim (head_dim)."""
    dl = t.shape[-1] // hs.tp
    return t[..., hs.rank * dl:(hs.rank + 1) * dl]


def _attend_kv(hs: Optional[HeadSplit], t: torch.Tensor) -> torch.Tensor:
    """What this rank's q reads of k or v as projected: the kv heads of
    its q heads, or, where q is split over head_dim, the same slice of
    head_dim of every kv head."""
    if hs is None or hs.kv_sharded:
        return t
    if hs.q_dim:
        return _dim_slice(hs, t)
    return t[:, :, hs.kv0:hs.kv0 + hs.nkv]


def _cache_kv(hs: Optional[HeadSplit], t: torch.Tensor) -> torch.Tensor:
    """k or v as projected, in the layout of this rank's KV cache."""
    if hs is None or hs.cache != "head_dim":
        return t
    return _dim_slice(hs, t)


def _attn_out(p: Params, hs: Optional[HeadSplit], x: torch.Tensor,
              out: torch.Tensor, sp: bool = False,
              mult: float = 1.0) -> torch.Tensor:
    """Residual + output projection (times ``mult`` before the add); a
    split layer's partial sums are added up over the ranks (the block's
    one all-reduce), or, over a sequence-split stream (``sp``),
    reduce-scattered onto the rank's rows."""
    y = _out_proj(out, p["wo"])
    if mult != 1.0:
        y = y * mult
    if hs is None:
        return x + y
    return x + (SH.reduce_scatter_to_sp(y) if sp else SH.reduce_from_tp(y))


def whole_rows(fn, x: torch.Tensor):
    """``fn`` over the whole sequence of a sequence-split stream, of
    which ``x`` holds this rank's rows: the rows gathered with
    ``gather_from_tp`` (every rank computes the same whole, so the
    backward keeps its rows' gradient), ``fn`` run whole, and the rank's
    rows of its result kept with ``scatter_to_sp``. ``fn`` returns the
    stream, or a tuple that starts with it."""
    out = fn(SH.gather_from_tp(x, 1))
    if isinstance(out, tuple):
        return (SH.scatter_to_sp(out[0]),) + out[1:]
    return SH.scatter_to_sp(out)


def _norm_in(x: torch.Tensor, w: torch.Tensor, eps: float, split: bool,
             sp: bool) -> torch.Tensor:
    """A block's pre-norm of the rows this rank holds, entering the
    column-parallel region of a split layer: ``copy_to_tp`` on the
    normed rows; over a sequence-split stream (``sp``) ``copy_to_tp`` on
    the weight (each rank norms a part of the rows) and the normed rows
    gathered with ``gather_from_sp``."""
    if sp:
        return SH.gather_from_sp(rmsnorm(x, SH.copy_to_tp(w), eps))
    h = rmsnorm(x, w, eps)
    return SH.copy_to_tp(h) if split else h


# ---------------------------------------------------------------------------
# Attention split over head_dim (plain torch: the kernels take the softmax
# over a whole head)
# ---------------------------------------------------------------------------

# the largest f32 score chunk, in elements, that the head_dim-split
# attention forms at once ([B, H, rows, T] for a chunk of query rows): a
# rank's whole [16, 40, 4096, 4096] at llama4-scout's train_4k would be
# 43 GB
HEADDIM_CHUNK = 1 << 29


def _masked_scores(q: torch.Tensor, k: torch.Tensor, qpos: torch.Tensor,
                   kpos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """Whole-head scores of a chunk of query rows from this rank's slices:
    q [B,rows,Hkv,g,dl] (scaled) and k [B,T,Hkv,dl] in the compute dtype;
    the partial q.k sums formed and all-reduced over the tensor-parallel
    ranks at that width (the reference's scores, ``attention_ref``'s
    einsum, are in the compute dtype), then upcast to f32 and masked."""
    s = SH.tp_all_reduce(torch.einsum("bskgd,btkd->bkgst", q, k)).float()
    if causal or window is not None:
        rel = qpos[:, None] - kpos[None, :]
        drop = rel < 0 if causal else torch.zeros_like(rel, dtype=torch.bool)
        if window is not None:
            drop |= rel >= window
        s.masked_fill_(drop, NEG_INF)
    return s


def _chunks(B: int, S: int, H: int, T: int):
    rows = max(1, min(S, HEADDIM_CHUNK // (B * H * T)))
    return [(c, min(S, c + rows)) for c in range(0, S, rows)]


def _scaled(q: torch.Tensor, Hkv: int, scale: float) -> torch.Tensor:
    """q [B,rows,H,dl] scaled in f32 and grouped by kv head:
    [B,rows,Hkv,g,dl], f32."""
    return (q.float() * scale).unflatten(2, (Hkv, q.shape[2] // Hkv))


def _headdim_rows(q: torch.Tensor, k: torch.Tensor, vf: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                  window: Optional[int], scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head_dim-split forward of a chunk of query rows: q [B,rows,H,dl]
    and this rank's k [B,T,Hkv,dl] in the compute dtype, v f32 ->
    (this rank's slice of the output, f32 [B,rows,H,dl], and the rows'
    log-sum-exp of their scaled scores, f32 [B,Hkv,g,rows]): the scores
    all-reduced in the compute dtype, the softmax in f32, p.v on the
    slice."""
    qc = _scaled(q, k.shape[2], scale).to(q.dtype)
    p = _masked_scores(qc, k.to(q.dtype), qpos, kpos, causal, window)
    m = p.amax(dim=-1, keepdim=True)
    den = p.sub_(m).exp_().sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", p.div_(den), vf)
    return o.flatten(2, 3), (m + torch.log(den))[..., 0]


class _HeaddimAttention(torch.autograd.Function):
    """Attention from this rank's slices of head_dim: q [B,S,H,dl], k, v
    [B,T,Hkv,dl] -> this rank's slice of the output [B,S,H,dl]. Per chunk
    of query rows, forward: the scores all-reduced in the compute dtype,
    the softmax in f32, p.v on the slice; only q, k, v and the rows'
    log-sum-exp are kept. Backward: the scores again, d(p) = do.v^T
    all-reduced in the compute dtype (each rank holds a slice of it),
    then dq, dk, dv on the slices in f32. The chunk's [B, H, rows, T]
    f32 tensors are reused in place."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window):
        B, S, H, dl = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        scale = 1.0 / math.sqrt(dl * SH.tp_size())
        vf = v.float()
        out = torch.empty_like(q)
        lse = torch.empty((B, Hkv, H // Hkv, S), dtype=torch.float32,
                          device=q.device)
        for c0, c1 in _chunks(B, S, H, T):
            o, lse[..., c0:c1] = _headdim_rows(q[:, c0:c1], k, vf,
                                               qpos[c0:c1], kpos, causal,
                                               window, scale)
            out[:, c0:c1] = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, qpos, kpos, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, qpos, kpos, lse = ctx.saved_tensors
        B, S, H, dl = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        cd = q.dtype
        kc, vc, kf = k.to(cd), v.to(cd), k.float()
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(kf)
        for c0, c1 in _chunks(B, S, H, T):
            qf = _scaled(q[:, c0:c1], Hkv, ctx.scale)
            p = _masked_scores(qf.to(cd), kc, qpos[c0:c1], kpos, ctx.causal,
                               ctx.window)
            p.sub_(lse[..., c0:c1, None]).exp_()
            doc = do[:, c0:c1].to(cd).unflatten(2, (Hkv, H // Hkv))
            dv += torch.einsum("bkgst,bskgd->btkd", p, doc.float())
            ds = SH.tp_all_reduce(torch.einsum("bskgd,btkd->bkgst", doc,
                                               vc)).float()
            ds.sub_((p * ds).sum(dim=-1, keepdim=True)).mul_(p)
            dq[:, c0:c1] = torch.einsum("bkgst,btkd->bskgd", ds,
                                        kf).flatten(2, 3) * ctx.scale
            dk += torch.einsum("bkgst,bskgd->btkd", ds, qf)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def headdim_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``attention_ref``'s function over the tensor-parallel ranks'
    slices of head_dim (the reference's layout where the model axis
    divides head_dim but not the heads): q [B,S,H,hd/tp], k, v
    [B,T,Hkv,hd/tp] -> [B,S,H,hd/tp], this rank's slice of the output.
    Partial q.k scores are all-reduced in the compute dtype before the
    softmax (f32), which runs over whole heads; p.v stays on the slice. Differentiable; the
    scores are formed a chunk of query rows at a time (``HEADDIM_CHUNK``)
    and never kept. Counted in ``HEADDIM_TP_CALLS``."""
    registry().inc(HEADDIM_TP_CALLS)
    S, T = q.shape[1], k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=q.device)
    return _HeaddimAttention.apply(q, k, v, q_positions, kv_positions,
                                   causal, window)


@torch.no_grad()
def headdim_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_positions: torch.Tensor,
                             kv_positions: torch.Tensor,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``headdim_attention``'s causal forward for decode, without autograd,
    with the rows' log-sum-exp that its forward keeps: q [B,S,H,dl], k, v
    [B,T,Hkv,dl] -> (this rank's slice of the output [B,S,H,dl], lse f32
    [B,S,H], whole heads' and the same on every tensor-parallel rank). A
    row that sees no key (a context-parallel rank's slice wholly past the
    token or outside its window) gives 0 and -inf. Counted in
    ``HEADDIM_TP_CALLS``."""
    registry().inc(HEADDIM_TP_CALLS)
    B, S, H, dl = q.shape
    o, lse = _headdim_rows(q, k, v.float(), q_positions,
                           kv_positions, True, window,
                           1.0 / math.sqrt(dl * SH.tp_size()))
    rel = q_positions[:, None] - kv_positions[None, :]
    seen = rel >= 0
    if window is not None:
        seen &= rel < window
    live = seen.any(dim=-1)                                   # [S]
    lse = lse.permute(0, 3, 1, 2).reshape(B, S, H)
    return (torch.where(live[None, :, None, None], o, 0.0).to(q.dtype),
            torch.where(live[None, :, None], lse, -math.inf))


def _headdim_decode(hs: HeadSplit, q: torch.Tensor, ck: torch.Tensor,
                    cv: torch.Tensor, pos: int, window: Optional[int] = None,
                    lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention over a KV cache split on head_dim (the
    reference's decode fallback) through ``headdim_decode_attention``:
    slots 0..``pos`` (within ``window``) of cache slots that start at
    global slot ``lo`` (a context-parallel rank's slice; 0 otherwise).
    ``q`` is this rank's as projected: its slice of every head's head_dim
    where q is split so ([B,1,H,dl]), else its q heads ([B,1,nq,hd]),
    whose head_dim slice of every head is gathered first and whose output
    slices are gathered after. ck, cv: [B,T,Hkv,dl]. Returns this rank's
    output in ``q``'s layout and dtype, and the lse f32 [B,1,heads of q]
    that ``merge_attention`` takes."""
    qpos = torch.full((1,), pos, device=q.device)
    kpos = lo + torch.arange(ck.shape[1], device=q.device)
    if hs.q_dim:
        return headdim_decode_attention(q, ck, cv, qpos, kpos, window)
    qa = SH.gather_from_tp(q, dim=2)                        # [B,1,H,hd]
    o, lse = headdim_decode_attention(_dim_slice(hs, qa), ck, cv, qpos, kpos,
                                      window)               # [B,1,H,dl]
    o = SH.gather_from_tp(o, dim=-1)                        # [B,1,H,hd]
    heads = slice(hs.q0, hs.q0 + hs.nq)
    return o[:, :, heads], lse[:, :, heads]


def attn_qkv(p: Params, spec: AttnSpec, x: torch.Tensor,
             positions: torch.Tensor, sp: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v as this rank projects them: q of its heads (or, split over
    head_dim, its slice of every head's, rotated whole: the rotation
    pairs dim i with i + hd/2, which another rank holds); k, v of its kv
    heads, or of every kv head where the KV projection is whole. Over a
    sequence-split stream (``sp``) ``x`` is the rank's rows and q, k, v
    are of the whole sequence (``positions``)."""
    hs = head_split(spec)
    h = _norm_in(x, p["norm"], spec.norm_eps, hs is not None, sp)
    wk, wv = _kv_weights(p, hs)
    q, k, v = _proj(h, p["wq"]), _proj(h, wk), _proj(h, wv)
    if spec.use_rope:
        if hs is not None and hs.q_dim:
            q = _dim_slice(hs, apply_rope(SH.all_gather_tp(q, -1),
                                          positions, spec.rope_theta))
        else:
            q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _cross_q(p: Params, spec: AttnSpec, hs: Optional[HeadSplit],
             x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    h = _norm_in(x, p["norm"], spec.norm_eps, hs is not None, sp)
    return _proj(h, p["wq"])


TRAIN_ROUTES = ("attn.train_kernel", "attn.train_ref")


def _attend(hs: Optional[HeadSplit], q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, scale: Optional[float] = None,
            self_attn: bool = False, **kw) -> torch.Tensor:
    """Training attention (with its autograd) of this rank's q over k, v
    as projected: ``attention_ref`` on its heads, or ``headdim_attention``
    on its slice of head_dim (at the default scale only). Self-attention
    (``self_attn``: queries and keys at the same positions, ``arange``)
    on its heads takes the flash kernels and their backward
    (``ops.flash_attention_train``) where ``ops.flash_trains(q)``: on the
    card, bf16, head dim 64 or 128. A call with grad enabled counts its
    route in the registry (``TRAIN_ROUTES``: the kernels, or the plain
    attention of either kind)."""
    grad = torch.is_grad_enabled()
    if hs is not None and hs.q_dim:
        if scale is not None:
            raise NotImplementedError("a head_dim split at a set scale")
        if grad:
            registry().inc(TRAIN_ROUTES[1])
        return headdim_attention(q, _attend_kv(hs, k), _attend_kv(hs, v),
                                 **kw)
    k, v = _attend_kv(hs, k), _attend_kv(hs, v)
    kernel = self_attn and ops.flash_trains(q)
    if grad:
        registry().inc(TRAIN_ROUTES[0] if kernel else TRAIN_ROUTES[1])
    if kernel:
        return ops.flash_attention_train(q, k, v, causal=kw["causal"],
                                         window=kw["window"], scale=scale)
    return attention_ref(q, k, v, scale=scale, **kw)


def attn_apply(p: Params, spec: AttnSpec, x: torch.Tensor, *,
               positions: torch.Tensor,
               memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               sp: bool = False) -> torch.Tensor:
    """Self- (or cross-, if ``memory``) attention with residual.
    ``memory`` is ``cross_attn_memory``'s (k, v). ``sp``: ``x`` is this
    rank's rows of a sequence-split stream, and so is the result.
    ``positions`` is ``arange(S)`` (``Model._inputs``'): the flash
    kernels of self-attention's route mask by row and column index."""
    hs = head_split(spec)
    if sp and hs is None:
        return whole_rows(lambda xw: attn_apply(
            p, spec, xw, positions=positions, memory=memory), x)
    if spec.cross:
        assert memory is not None
        mk, mv = memory
        out = _attend(hs, _cross_q(p, spec, hs, x, sp), mk, mv,
                      causal=False)
    else:
        q, k, v = attn_qkv(p, spec, x, positions, sp)
        out = _attend(hs, q, k, v, causal=spec.causal, window=spec.window,
                      q_positions=positions, kv_positions=positions,
                      scale=spec.scale, self_attn=True)
    return _attn_out(p, hs, x, out, sp, spec.res_mult)


def attn_prefill(p: Params, spec: AttnSpec, x: torch.Tensor, *,
                 positions: torch.Tensor, impl: Optional[str] = None,
                 sp: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like attn_apply, through the flash kernel (on the rank's heads in
    a split context; ``headdim_attention`` where q is split over
    head_dim), and also returns the KV cache {k, v} [B,S,Hkv,hd] in this
    rank's layout. ``positions`` is ``arange(S)``: the kernel masks by
    row and column index. ``sp``: ``x`` is this rank's rows of a
    sequence-split stream, as the result is; the kernel runs on the
    gathered rows and the cache holds the whole sequence."""
    hs = head_split(spec)
    if sp and hs is None:
        return whole_rows(lambda xw: attn_prefill(
            p, spec, xw, positions=positions, impl=impl), x)
    q, k, v = attn_qkv(p, spec, x, positions, sp)
    if hs is not None and hs.q_dim:
        out = _attend(hs, q, k, v, causal=spec.causal, window=spec.window,
                      scale=spec.scale)
    else:
        out = ops.flash_attention(q, _attend_kv(hs, k), _attend_kv(hs, v),
                                  causal=spec.causal, window=spec.window,
                                  impl=impl, scale=spec.scale)
    return _attn_out(p, hs, x, out, sp, spec.res_mult), {
        "k": _cache_kv(hs, k), "v": _cache_kv(hs, v)}


def attn_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
                cache: Dict[str, torch.Tensor],
                pos: Union[int, torch.Tensor], *,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B,1,d]; cache k/v: [B,S_max,Hkv,hd] (this
    rank's slice in a split context); pos int, or for a cache split over
    nothing a 0-d int32 tensor on x's device (a step captured in a CUDA
    graph: the host never reads it), which gives the int's values.

    Writes this token's k/v into slot ``pos`` of the cache IN PLACE (the
    reference's ``dynamic_update_slice`` on a donated buffer) and returns
    the same cache tensors.

    A cache split over ``kvseq`` (``specs.kvseq_active``: this rank holds
    global slots [lo, hi)) is written only by the rank that holds
    ``pos``, at ``pos - lo``; each rank attends over its slots
    lo..min(pos, hi - 1) and the ranks' results are merged
    (``_cp_decode``). A cache whose slots the data ranks do not divide is
    whole on each of them (``specs.kvseq_range`` reads its layout from
    the global slot count its tensor carries) and decodes as without the
    split: every rank writes and reads every slot, nothing merged.
    """
    B = x.shape[0]
    hs = head_split(spec)
    tensor_pos = isinstance(pos, torch.Tensor)
    positions = (pos.reshape(1, 1).expand(B, 1) if tensor_pos else
                 torch.full((B, 1), pos, dtype=torch.int32, device=x.device))
    q, k, v = attn_qkv(p, spec, x, positions)
    ck, cv = cache["k"], cache["v"]
    split = SH.kvseq_range(ck)
    if split is not None:
        lo, hi = split
        if lo <= pos < hi:
            ck[:, pos - lo] = _cache_kv(hs, k)[:, 0].to(ck.dtype)
            cv[:, pos - lo] = _cache_kv(hs, v)[:, 0].to(cv.dtype)
        out = _cp_decode(hs, q, ck, cv, pos, lo, spec.window, impl,
                         spec.scale)
        return _attn_out(p, hs, x, out, mult=spec.res_mult), cache
    if tensor_pos:
        slot = pos.reshape(1).long()
        ck.index_copy_(1, slot, _cache_kv(hs, k).to(ck.dtype))
        cv.index_copy_(1, slot, _cache_kv(hs, v).to(cv.dtype))
    else:
        ck[:, pos] = _cache_kv(hs, k)[:, 0].to(ck.dtype)
        cv[:, pos] = _cache_kv(hs, v)[:, 0].to(cv.dtype)
    if hs is not None and hs.cache == "head_dim":
        if spec.scale is not None:
            raise NotImplementedError("a head_dim split at a set scale")
        out = _headdim_decode(hs, q, ck, cv, pos, spec.window)[0]
    elif spec.window is not None:
        # the decode kernel has no window, as the TPU kernel has none:
        # windowed (local) layers decode through attention_ref, as every
        # layer of the JAX model does
        registry().inc(WINDOW_REF_DECODES)
        out = attention_ref(q, _attend_kv(hs, ck), _attend_kv(hs, cv),
                            causal=True, window=spec.window,
                            q_positions=positions[0],
                            kv_positions=torch.arange(ck.shape[1],
                                                      device=x.device),
                            scale=spec.scale)
    else:
        out = ops.decode_attention(q, _attend_kv(hs, ck), _attend_kv(hs, cv),
                                   pos, impl=impl, scale=spec.scale)
    return _attn_out(p, hs, x, out, mult=spec.res_mult), cache


def decode_counter(spec: AttnSpec) -> Any:
    """What a decode of ``spec``'s layer split over no mesh counts."""
    return WINDOW_REF_DECODES if spec.window is not None else DECODE_LAUNCHES


def _cp_decode(hs: Optional[HeadSplit], q: torch.Tensor, ck: torch.Tensor,
               cv: torch.Tensor, pos: int, lo: int, window: Optional[int],
               impl: Optional[str], scale: Optional[float] = None
               ) -> torch.Tensor:
    """One-token attention of a context-parallel rank over its slice of a
    ``kvseq``-split cache, global slots [lo, lo + T_local), merged over
    the data ranks (``specs.merge_attention``). The rank reads its slots
    up to ``pos`` (local ``min(pos, hi - 1) - lo``, -1 where ``pos <
    lo``: an empty slice) through the reader its layout takes, each
    returning (out, lse): ``_headdim_decode`` for a head_dim-split cache,
    ``attention_ref`` at ``kv_positions = lo + arange`` for a windowed
    layer, else the decode kernel with its ``lse``."""
    T = ck.shape[1]
    last = max(-1, min(pos, lo + T - 1) - lo)
    if hs is not None and hs.cache == "head_dim":
        if scale is not None:
            raise NotImplementedError("a head_dim split at a set scale")
        out, lse = _headdim_decode(hs, q, ck, cv, pos, window, lo=lo)
    elif window is not None:
        registry().inc(WINDOW_REF_DECODES)
        out, lse = attention_ref(
            q, _attend_kv(hs, ck), _attend_kv(hs, cv), causal=True,
            window=window, q_positions=torch.full((1,), pos,
                                                  device=q.device),
            kv_positions=lo + torch.arange(T, device=q.device),
            return_lse=True, scale=scale)
    else:
        out, lse = ops.decode_attention(q, _attend_kv(hs, ck),
                                        _attend_kv(hs, cv), last, impl=impl,
                                        return_lse=True, scale=scale)
    return SH.merge_attention(out, lse)


def cross_attn_memory(p: Params, spec: AttnSpec, enc_out: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V of the encoder output for cross-attention: [B,T_enc,Hkv,hd]
    (this rank's kv heads, or every kv head where the projection is
    whole)."""
    hs = head_split(spec)
    if hs is not None:
        enc_out = SH.copy_to_tp(enc_out)
    wk, wv = _kv_weights(p, hs)
    return _proj(enc_out, wk), _proj(enc_out, wv)


def cross_attn_cache(spec: AttnSpec, memory: Tuple[torch.Tensor,
                                                   torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The cross-attention memory in this rank's cache layout (and this
    rank's slice of its slots where the serving call splits it over
    ``kvseq``)."""
    hs = head_split(spec)
    lo, hi = SH.kvseq_slice(memory[0].shape[1])
    return {"mk": _cache_kv(hs, memory[0][:, lo:hi]),
            "mv": _cache_kv(hs, memory[1][:, lo:hi])}


def cross_attn_prefill(p: Params, spec: AttnSpec, x: torch.Tensor,
                       memory: Tuple[torch.Tensor, torch.Tensor], *,
                       impl: Optional[str] = None,
                       sp: bool = False) -> torch.Tensor:
    """Cross-attention of the prompt over the encoder memory
    (``cross_attn_memory``'s) through the flash kernel, non-causal:
    every query sees every memory slot. ``sp`` as in ``attn_prefill``."""
    hs = head_split(spec)
    if sp and hs is None:
        return whole_rows(lambda xw: cross_attn_prefill(
            p, spec, xw, memory, impl=impl), x)
    mk, mv = memory
    q = _cross_q(p, spec, hs, x, sp)
    if hs is not None and hs.q_dim:
        out = _attend(hs, q, mk, mv, causal=False)
    else:
        out = ops.flash_attention(q, _attend_kv(hs, mk), _attend_kv(hs, mv),
                                  causal=False, impl=impl)
    return _attn_out(p, hs, x, out, sp)


def cross_attn_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
                      memory: Tuple[torch.Tensor, torch.Tensor], *,
                      impl: Optional[str] = None) -> torch.Tensor:
    """One-token cross-attention over the cached encoder memory (this
    rank's layout) through the decode kernel at ``pos = T_enc - 1``:
    every slot is visible, the reference's ``attention_ref(...,
    causal=False)``. A memory split over ``kvseq`` is read the same way
    on each rank's slice, every slot of it visible, and the ranks'
    results are merged (``_cp_decode``)."""
    hs = head_split(spec)
    mk, mv = memory
    q = _cross_q(p, spec, hs, x)
    split = SH.kvseq_range(mk)
    if split is not None:
        lo, hi = split
        out = _cp_decode(hs, q, mk, mv, hi - 1, lo, None, impl)
        return _attn_out(p, hs, x, out)
    if hs is not None and hs.cache == "head_dim":
        out = _headdim_decode(hs, q, mk, mv, mk.shape[1] - 1)[0]
    else:
        out = ops.decode_attention(q, _attend_kv(hs, mk), _attend_kv(hs, mv),
                                   mk.shape[1] - 1, impl=impl)
    return _attn_out(p, hs, x, out)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_model: int
    d_ff: int
    act: str                       # swiglu | squared_relu | gelu
    norm_eps: float


def mlp_init(b: ParamBuilder, spec: MLPSpec) -> None:
    d, f = spec.d_model, spec.d_ff
    b.add("norm", (d,), ("embed_nt",), init="ones")
    if spec.act == "swiglu":
        b.add("wg", (d, f), ("embed", "ff"))
        b.add("wu", (d, f), ("embed", "ff"))
    else:
        b.add("wu", (d, f), ("embed", "ff"))
    b.add("wd", (f, d), ("ff", "embed"), scale=1.0 / math.sqrt(f))


def _mlp_split(spec: MLPSpec) -> bool:
    """Whether the active context splits the MLP's ``ff`` over the
    model axis."""
    return SH.tp_size() > 1 and SH.active_leaf_spec(
        ("embed", "ff"), (spec.d_model, spec.d_ff))[1] is not None


def mlp_core(p: Params, spec: MLPSpec, h: torch.Tensor,
             sp: bool = False) -> torch.Tensor:
    """The un-normed, un-residualed FFN body; in a split context
    column-parallel (``wg``, ``wu``) then row-parallel (``wd``) over the
    rank's slice of ``ff``, the partial sums added up over the ranks.
    ``sp``: ``h`` is the rank's rows of a sequence-split stream, gathered
    on the way in and reduce-scattered on the way out (a split MLP)."""
    if _mlp_split(spec):
        if sp:
            return SH.reduce_scatter_to_sp(
                _mlp_body(p, spec, SH.gather_from_sp(h)))
        return SH.reduce_from_tp(_mlp_body(p, spec, SH.copy_to_tp(h)))
    return _mlp_body(p, spec, h)


def _mlp_body(p: Params, spec: MLPSpec, h: torch.Tensor) -> torch.Tensor:
    if spec.act == "swiglu":
        return (F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    if spec.act == "squared_relu":
        return torch.square(F.relu(h @ p["wu"])) @ p["wd"]
    if spec.act == "gelu":
        return F.gelu(h @ p["wu"], approximate="tanh") @ p["wd"]
    raise ValueError(spec.act)


def mlp_apply(p: Params, spec: MLPSpec, x: torch.Tensor,
              sp: bool = False) -> torch.Tensor:
    """Pre-norm MLP with residual; ``sp`` as in ``attn_apply``."""
    if sp and not _mlp_split(spec):
        return whole_rows(lambda xw: mlp_apply(p, spec, xw), x)
    w = SH.copy_to_tp(p["norm"]) if sp else p["norm"]
    return x + mlp_core(p, spec, rmsnorm(x, w, spec.norm_eps), sp)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(b: ParamBuilder, vocab: int, d_model: int, tie: bool) -> None:
    b.add("embedding", (vocab, d_model), ("vocab", "embed"), scale=0.02)
    if not tie:
        b.add("unembed", (d_model, vocab), ("embed", "vocab"),
              scale=1.0 / math.sqrt(d_model))


def vocab_start(vocab: Optional[int]) -> Optional[int]:
    """First vocab row this rank holds of a ``vocab``-row embedding split
    over the tensor-parallel ranks; ``None`` when it is not split."""
    if vocab is None or SH.tp_size() == 1 or SH.active_leaf_spec(
            ("vocab", "embed"), (vocab, 1))[0] is None:
        return None
    return SH.tp_rank() * (vocab // SH.tp_size())


def embed_apply(p: Params, tokens: torch.Tensor, dtype,
                vocab: Optional[int] = None, sp: bool = False
                ) -> torch.Tensor:
    """Token embeddings. ``vocab`` is the (padded) whole vocab: given
    and split over the tensor-parallel ranks, each rank looks up the ids
    in its rows, zero for the others, and the ranks' parts are added up
    (vocab-parallel). ``sp``: ``tokens`` [B, S] are the whole sequence
    of a sequence-split stream, and the result is this rank's rows: the
    vocab-parallel parts reduce-scattered over the sequence, a whole
    lookup cut with ``scatter_to_sp``."""
    # index_select: its backward is index_add, which takes a deterministic
    # implementation on the card under torch.use_deterministic_algorithms
    emb = p["embedding"]
    v0 = vocab_start(vocab)
    shape = (*tokens.shape, emb.shape[-1])
    if v0 is None:
        out = torch.index_select(emb, 0, tokens.reshape(-1))
        if sp:
            return SH.scatter_to_sp(out.reshape(shape)).to(dtype)
    else:
        ids = tokens.reshape(-1) - v0
        inside = (ids >= 0) & (ids < emb.shape[0])
        out = torch.index_select(emb, 0, ids.clamp(0, emb.shape[0] - 1))
        out = out * inside[:, None].to(out.dtype)
        if sp:
            return SH.reduce_scatter_to_sp(out.reshape(shape)).to(dtype)
        out = SH.reduce_from_tp(out)
    return out.reshape(shape).to(dtype)


def unembed_apply(p: Params, x: torch.Tensor, tie: bool,
                  vocab: Optional[int] = None, sp: bool = False
                  ) -> torch.Tensor:
    """Logits; split over the tensor-parallel ranks with the vocab (see
    ``embed_apply``), each rank's slice of the vocab, as the reference
    constrains them. ``sp``: ``x`` is the rank's rows of a
    sequence-split stream, and the logits are of the whole sequence."""
    # Logits stay in the compute dtype; the loss upcasts inside its
    # reductions.
    if vocab_start(vocab) is not None:
        x = SH.gather_from_sp(x) if sp else SH.copy_to_tp(x)
    elif sp:
        x = SH.gather_from_tp(x, 1)
    if tie:
        return torch.matmul(x, p["embedding"].t())
    return torch.matmul(x, p["unembed"])
