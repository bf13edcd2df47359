"""Core model layers: norms, RoPE, GQA attention, MLP variants.

Port of ``repro/models/layers.py``. Parameters are plain dicts of
tensors, named and laid out as in the reference, so a JAX init converts
one to one (``repro_torch.convert``). Training attention
is the plain reference path (``attention_ref``) with its autograd: the
TPU flash kernel has no backward. Serving goes through the hand-written
kernels of ``kernels.ops``: prefill through flash_attention, decode
through decode_attention, over a cache updated in place. Cross-attention
(enc-dec) serves through the same two kernels over the encoder memory
``mk``/``mv``: non-causal flash in prefill, decode at ``pos = T_enc - 1``
(every slot visible) in each step. Each builder
also records the *logical dims* of every leaf (e.g.
``("embed", "q_dim")``) in a parallel dict, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Any
Dims = Any
# decode calls of windowed layers, which run attention_ref (no kernel)
WINDOW_REF_DECODES: Dict[str, int] = {"attention_ref": 0}


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
                  kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,S,Hq,hd]; k,v: [B,T,Hkv,hd] -> [B,S,Hq,hd].

    ``window`` (if set) restricts attention to the last ``window`` keys
    relative to each query (sliding-window / local attention).
    """
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    # scores stay in the compute dtype; softmax reductions accumulate f32
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(hd)

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
    neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device)
    scores = torch.where(mask[None, None, None], scores, neg)
    m = scores.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(scores - m)                                # compute dtype
    denom = p.float().sum(dim=-1, keepdim=True).to(p.dtype)
    probs = p / torch.clamp_min(denom, torch.tensor(1e-30, dtype=p.dtype,
                                                    device=p.device))
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, hd)


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


def attn_qkv(p: Params, spec: AttnSpec, x: torch.Tensor,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = rmsnorm(x, p["norm"], spec.norm_eps)
    q, k, v = _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def attn_apply(p: Params, spec: AttnSpec, x: torch.Tensor, *,
               positions: torch.Tensor,
               memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Self- (or cross-, if ``memory``) attention with residual."""
    if spec.cross:
        assert memory is not None
        mk, mv = memory
        h = rmsnorm(x, p["norm"], spec.norm_eps)
        out = attention_ref(_proj(h, p["wq"]), mk, mv, causal=False)
    else:
        q, k, v = attn_qkv(p, spec, x, positions)
        out = attention_ref(q, k, v, causal=spec.causal, window=spec.window,
                            q_positions=positions, kv_positions=positions)
    return x + _out_proj(out, p["wo"])


def attn_prefill(p: Params, spec: AttnSpec, x: torch.Tensor, *,
                 positions: torch.Tensor, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like attn_apply, through the flash kernel, and also returns the KV
    cache {k, v} [B,S,Hkv,hd]. ``positions`` is ``arange(S)``: the kernel
    masks by row and column index."""
    q, k, v = attn_qkv(p, spec, x, positions)
    out = ops.flash_attention(q, k, v, causal=spec.causal,
                              window=spec.window, impl=impl)
    return x + _out_proj(out, p["wo"]), {"k": k, "v": v}


def attn_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int, *,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B,1,d]; cache k/v: [B,S_max,Hkv,hd]; pos int.

    Writes this token's k/v into slot ``pos`` of the cache IN PLACE (the
    reference's ``dynamic_update_slice`` on a donated buffer) and returns
    the same cache tensors.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = attn_qkv(p, spec, x, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    if spec.window is not None:
        # the decode kernel has no window, as the TPU kernel has none:
        # windowed (local) layers decode through attention_ref, as every
        # layer of the JAX model does
        WINDOW_REF_DECODES["attention_ref"] += 1
        out = attention_ref(q, ck, cv, causal=True, window=spec.window,
                            q_positions=positions[0],
                            kv_positions=torch.arange(ck.shape[1],
                                                      device=x.device))
    else:
        out = ops.decode_attention(q, ck, cv, pos, impl=impl)
    return x + _out_proj(out, p["wo"]), cache


def cross_attn_memory(p: Params, spec: AttnSpec, enc_out: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V of the encoder output for cross-attention: [B,T_enc,Hkv,hd]."""
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


def cross_attn_prefill(p: Params, spec: AttnSpec, x: torch.Tensor,
                       memory: Tuple[torch.Tensor, torch.Tensor], *,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Cross-attention of the prompt over the encoder memory through the
    flash kernel, non-causal: every query sees every memory slot."""
    mk, mv = memory
    h = rmsnorm(x, p["norm"], spec.norm_eps)
    out = ops.flash_attention(_proj(h, p["wq"]), mk, mv, causal=False,
                              impl=impl)
    return x + _out_proj(out, p["wo"])


def cross_attn_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
                      memory: Tuple[torch.Tensor, torch.Tensor], *,
                      impl: Optional[str] = None) -> torch.Tensor:
    """One-token cross-attention over the encoder memory through the
    decode kernel at ``pos = T_enc - 1``: every slot is visible, the
    reference's ``attention_ref(..., causal=False)``."""
    mk, mv = memory
    h = rmsnorm(x, p["norm"], spec.norm_eps)
    out = ops.decode_attention(_proj(h, p["wq"]), mk, mv, mk.shape[1] - 1,
                               impl=impl)
    return x + _out_proj(out, p["wo"])


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


def mlp_core(p: Params, spec: MLPSpec, h: torch.Tensor) -> torch.Tensor:
    """The un-normed, un-residualed FFN body."""
    if spec.act == "swiglu":
        return (F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    if spec.act == "squared_relu":
        return torch.square(F.relu(h @ p["wu"])) @ p["wd"]
    if spec.act == "gelu":
        return F.gelu(h @ p["wu"], approximate="tanh") @ p["wd"]
    raise ValueError(spec.act)


def mlp_apply(p: Params, spec: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], spec.norm_eps)
    return x + mlp_core(p, spec, h)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(b: ParamBuilder, vocab: int, d_model: int, tie: bool) -> None:
    b.add("embedding", (vocab, d_model), ("vocab", "embed"), scale=0.02)
    if not tie:
        b.add("unembed", (d_model, vocab), ("embed", "vocab"),
              scale=1.0 / math.sqrt(d_model))


def embed_apply(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # index_select: its backward is index_add, which takes a deterministic
    # implementation on the card under torch.use_deterministic_algorithms
    emb = p["embedding"]
    out = torch.index_select(emb, 0, tokens.reshape(-1))
    return out.reshape(*tokens.shape, emb.shape[-1]).to(dtype)


def unembed_apply(p: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    # Logits stay in the compute dtype; the loss upcasts inside its
    # reductions.
    if tie:
        return torch.matmul(x, p["embedding"].t())
    return torch.matmul(x, p["unembed"])
