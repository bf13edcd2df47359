"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, true recurrence).

Port of ``repro/models/xlstm.py``, in plain PyTorch as the reference is
plain ``jnp`` (no Pallas kernel):
  * mLSTM trains and prefills in the reference's chunked linear-attention
    form: quadratic within ``CHUNK``-sized tiles, one recurrent
    ``[B,H,hd,hd]`` f32 state carried across tiles. The reference's
    ``lax.scan`` over chunks becomes a loop over chunks. Input-gate
    pre-activations are clipped at ``ICLIP`` in place of a global
    max-stabilizer, as in the reference.
  * sLSTM has head-recurrent weights (``h_{t-1}`` enters the gates), so
    its ``lax.scan`` over time becomes a Python loop over time, with the
    exp-gating stabilizer state ``m``.
Gates and states are f32, with the reference's casts. Decode is one step
of each recurrence and writes the new states (mLSTM ``C``, ``n``,
``conv``; sLSTM ``c``, ``n``, ``h``, ``m``) into the cache in place, as
``ssm.mamba_decode`` does.

Under ``sharding.specs.activation_sharding(axes, mesh)`` with a model
axis, the blocks are split as ``leaf_spec`` lays their params out:
  * mLSTM, as GSPMD splits the reference's: ``up_proj`` column-parallel,
    one all-to-all (``specs.relayout_halves``) to the rank's
    ``d_inner / tp`` channels of ``xu`` and ``z``, the conv on them
    (``conv_w``/``conv_b`` whole, sliced from ``copy_to_tp``); ``wq``,
    ``wk``, ``wv``, ``w_o``, ``w_i`` and ``w_f`` row-parallel, their
    partial sums packed into one all-reduce (GSPMD's tuple all-reduce);
    the chunked recurrence whole on every rank (``C`` and ``n`` whole, as
    ``cache_dims`` lays them out); ``h * o`` enters the split work
    through ``copy_to_tp``, narrowed to the rank's channels,
    ``* silu(z)``, ``down_proj`` row-parallel and all-reduced.
  * sLSTM: ``wx`` column-parallel and one all-gather of ``xw`` (the
    contiguous split of the fused ``4d`` joins in rank order), then
    ``bias`` and the recurrence whole on every rank (``c``, ``n``, ``h``,
    ``m`` are ``embed_nt``), then the FFN column/row-parallel over ``ff``
    (``layers.mlp_core``). This departs from GSPMD on purpose: it splits
    the reference's recurrence over units, with 12 collective-permutes of
    [B, d/4] and an all-reduce of [B, d] inside every time step, which an
    eager loop cannot afford (4,096 steps a layer at ``train_4k``). Every
    rank instead runs the recurrence's B·4·d·hd multiply-adds a step
    whole, so a rank's sLSTM bytes and FLOPs exceed GSPMD's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models.layers import MLPSpec, ParamBuilder, mlp_core, rmsnorm
from repro_torch.models.ssm import (_causal_conv, in_halves, inner_split,
                                    whole_slices)
from repro_torch.sharding import specs as SH

Params = Any
CHUNK = 128
ICLIP = 8.0          # clip on input-gate pre-activation (stabilizer stand-in)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLSTMSpec:
    d_model: int
    n_heads: int
    cfg: XLSTMConfig
    norm_eps: float

    @property
    def d_inner(self) -> int:
        return int(self.cfg.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def mlstm_init(b: ParamBuilder, spec: MLSTMSpec) -> None:
    d, dm, H, W = spec.d_model, spec.d_inner, spec.n_heads, spec.cfg.conv_width
    b.add("norm", (d,), ("embed_nt",), init="ones")
    b.add("up_proj", (d, 2 * dm), ("embed", "xl_inner"))
    b.add("conv_w", (W, dm), (None, "xl_inner_nt"), scale=1.0 / math.sqrt(W))
    b.add("conv_b", (dm,), ("xl_inner_nt",), init="zeros")
    b.add("wq", (dm, dm), ("xl_inner", "xl_inner2"))
    b.add("wk", (dm, dm), ("xl_inner", "xl_inner2"))
    b.add("wv", (dm, dm), ("xl_inner", "xl_inner2"))
    b.add("w_i", (dm, H), ("xl_inner", None), scale=0.02)
    b.add("w_f", (dm, H), ("xl_inner", None), scale=0.02)
    b.add("b_i", (H,), (None,), init="zeros")
    b.add("b_f", (H,), (None,), init="ones")
    b.add("w_o", (dm, dm), ("xl_inner", "xl_inner2"))
    b.add("down_proj", (dm, d), ("xl_inner", "embed"),
          scale=1.0 / math.sqrt(dm))


def _mlstm_qkvgates(p: Params, spec: MLSTMSpec, x: torch.Tensor,
                    conv_state: Optional[torch.Tensor] = None):
    """x: [B,S,d] -> q,k,v [B,S,H,hd], log_i/log_f [B,S,H] f32, o, z,
    conv_state, and the rank's channels (``None`` unsplit). Split: the
    row-parallel partial sums of q, k, v, o [B,S,dm] and of the gates
    [B,S,H] are added up over the ranks in one all-reduce, so q, k, v,
    log_i, log_f and o are whole on every rank, z and conv_state the
    rank's channels."""
    B, S, _ = x.shape
    H, hd, dm = spec.n_heads, spec.head_dim, spec.d_inner
    ch = inner_split("xl_inner", spec.d_model, dm, 2)
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xu, z = in_halves(h0, p["up_proj"], ch is not None)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if ch is not None:
        conv_w, conv_b = whole_slices([conv_w, conv_b], (-1, -1), ch)
    xc, conv_state = _causal_conv(xu, conv_w, conv_b, conv_state)
    xc = F.silu(xc)
    parts = (xc @ p["wq"], xc @ p["wk"], xu @ p["wv"], xu @ p["w_o"],
             xc @ p["w_i"], xc @ p["w_f"])
    if ch is not None:
        parts = torch.split(SH.reduce_from_tp(torch.cat(parts, dim=-1)),
                            [dm] * 4 + [H] * 2, dim=-1)
    q, k, v, o, i_r, f_r = parts
    q = q.reshape(B, S, H, hd)
    k = (k / math.sqrt(hd)).reshape(B, S, H, hd)
    v = v.reshape(B, S, H, hd)
    log_i = torch.clamp((i_r + p["b_i"]).float(), -ICLIP, ICLIP)  # [B,S,H]
    log_f = F.logsigmoid((f_r + p["b_f"]).float())
    o = torch.sigmoid(o)                                      # [B,S,dm]
    return q, k, v, log_i, log_f, o, z, conv_state, ch


def _mlstm_out(p: Params, h: torch.Tensor, o: torch.Tensor, z: torch.Tensor,
               ch: Optional[slice]) -> torch.Tensor:
    """``(h * o) * silu(z) @ down_proj``. Split: ``h * o``, whole on every
    rank, enters the rank's channels through ``copy_to_tp`` (each rank's
    gradient of it is a part), and the partial sums are added up."""
    if ch is None:
        return ((h * o) * F.silu(z)) @ p["down_proj"]
    ho = SH.copy_to_tp(h * o)[..., ch]
    return SH.reduce_from_tp((ho * F.silu(z)) @ p["down_proj"])


def _mlstm_forward(p: Params, spec: MLSTMSpec, x: torch.Tensor,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, _ = x.shape
    H, hd = spec.n_heads, spec.head_dim
    q, k, v, log_i, log_f, o, z, conv_state, ch = _mlstm_qkvgates(
        p, spec, x)

    nc = max(1, S // CHUNK)
    Q = S // nc
    if nc * Q != S:       # the reference asserts the same
        raise AssertionError(f"seq {S} not divisible into chunks of {Q}")
    qf, kf, vf = (t.float() for t in (q, k, v))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    hs = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        qc, kc, vc, li, lf = qf[:, sl], kf[:, sl], vf[:, sl], \
            log_i[:, sl], log_f[:, sl]
        L = torch.cumsum(lf, dim=1)                           # [B,Q,H]
        # intra-chunk decay matrix D[t,s] = exp(L_t - L_s + li_s), s <= t
        Dlog = L[:, :, None, :] - L[:, None, :, :] + li[:, None, :, :]
        Dm = torch.where(tri[None, :, :, None], torch.exp(Dlog),
                         torch.zeros((), device=x.device))    # [B,t,s,H]
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * Dm
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vc)
        n_intra = scores.sum(dim=2)                           # [B,Q,H]
        # inter-chunk contribution
        eL = torch.exp(L)                                     # [B,Q,H]
        y_inter = torch.einsum("bthd,bhde->bthe", qc, C) * eL[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", qc, n) * eL   # [B,Q,H]
        # state update
        Ltot = L[:, -1]                                       # [B,H]
        w = torch.exp(Ltot[:, None] - L + li)                 # [B,Q,H]
        C = (C * torch.exp(Ltot)[..., None, None]
             + torch.einsum("bshd,bshe,bsh->bhde", kc, vc, w))
        n = (n * torch.exp(Ltot)[..., None]
             + torch.einsum("bshd,bsh->bhd", kc, w))
        denom = torch.clamp_min((n_intra + n_inter).abs(), 1.0)  # [B,Q,H]
        hs.append((y_intra + y_inter) / denom[..., None])     # [B,Q,H,hd]
    h = torch.cat(hs, dim=1).reshape(B, S, -1).to(x.dtype)
    out = _mlstm_out(p, h, o, z, ch)
    return x + out, {"C": C, "n": n, "conv": conv_state}


def mlstm_apply(p: Params, spec: MLSTMSpec, x: torch.Tensor) -> torch.Tensor:
    return _mlstm_forward(p, spec, x)[0]


def mlstm_prefill(p: Params, spec: MLSTMSpec, x: torch.Tensor,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _mlstm_forward(p, spec, x)


def mlstm_cache_init(spec: MLSTMSpec, batch: int, dtype,
                     device: Any) -> Dict[str, torch.Tensor]:
    H, hd, W = spec.n_heads, spec.head_dim, spec.cfg.conv_width
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=f32, device=device),
        "conv": torch.zeros((batch, W - 1, spec.d_inner), dtype=dtype,
                            device=device),
    }


def mlstm_decode(p: Params, spec: MLSTMSpec, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B,1,d]. Writes the new ``C``, ``n`` and
    ``conv`` into ``cache`` IN PLACE and returns the same cache tensors."""
    B = x.shape[0]
    q, k, v, log_i, log_f, o, z, conv_state, ch = _mlstm_qkvgates(
        p, spec, x, cache["conv"])
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))        # [B,H,hd]
    i_g = torch.exp(log_i[:, 0])[..., None]                   # [B,H,1]
    f_g = torch.exp(log_f[:, 0])[..., None]
    C_new = f_g[..., None] * cache["C"] + i_g[..., None] * (
        kf[..., :, None] * vf[..., None, :])                  # [B,H,hd,hd]
    n_new = f_g * cache["n"] + i_g * kf
    y = torch.einsum("bhd,bhde->bhe", qf, C_new)
    denom = torch.clamp_min(
        torch.einsum("bhd,bhd->bh", qf, n_new).abs(), 1.0)
    h = (y / denom[..., None]).reshape(B, 1, -1).to(x.dtype)
    out = _mlstm_out(p, h, o, z, ch)
    cache["C"].copy_(C_new)
    cache["n"].copy_(n_new)
    cache["conv"].copy_(conv_state)
    return x + out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLSTMSpec:
    d_model: int
    n_heads: int
    norm_eps: float

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return ((int(4 * self.d_model / 3) + 63) // 64) * 64


def slstm_init(b: ParamBuilder, spec: SLSTMSpec) -> None:
    d, H, hd = spec.d_model, spec.n_heads, spec.head_dim
    b.add("norm", (d,), ("embed_nt",), init="ones")
    b.add("wx", (d, 4 * d), ("embed", "xl_inner"))            # z,i,f,o fused
    b.add("r", (4, H, hd, hd), (None, None, None, None),
          scale=1.0 / math.sqrt(hd))
    b.add("bias", (4 * d,), ("xl_inner_nt",), init="zeros")
    b.add("wff_u", (d, spec.d_ff), ("embed", "ff"))
    b.add("wff_d", (spec.d_ff, d), ("ff", "embed"),
          scale=1.0 / math.sqrt(spec.d_ff))


def _slstm_cell(r: torch.Tensor, spec: SLSTMSpec, xw: torch.Tensor,
                state: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """One step. r: the recurrent weights [4,H,hd,hd] in f32 (the
    reference's einsum of f32 ``h`` with them promotes to f32); xw:
    [B, 4d] f32 (precomputed x projections + bias)."""
    B = xw.shape[0]
    H, hd, d = spec.n_heads, spec.head_dim, spec.d_model
    c, n, h, m = state                                        # each [B, d] f32
    rz, ri, rf, ro = torch.einsum("bhd,jhde->jbhe", h.reshape(B, H, hd),
                                  r).reshape(4, B, d)
    z_r, i_r, f_r, o_r = torch.chunk(xw, 4, dim=-1)
    z = torch.tanh(z_r + rz)
    i_log = torch.clamp(i_r + ri, -ICLIP, ICLIP)
    f_log = F.logsigmoid(f_r + rf)
    o = torch.sigmoid(o_r + ro)
    m_new = torch.maximum(f_log + m, i_log)
    i_p = torch.exp(i_log - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_xw(p: Params, spec: SLSTMSpec, h0: torch.Tensor) -> torch.Tensor:
    """The gates' input projections + bias, f32 [..., 4d]. Split: the
    rank's columns of ``wx``, joined in rank order by one all-gather."""
    d = spec.d_model
    if inner_split("xl_inner", d, 4 * d, 1) is None:
        return (h0 @ p["wx"] + p["bias"]).float()
    xw = SH.gather_from_tp(SH.copy_to_tp(h0) @ p["wx"], -1)
    return (xw + p["bias"]).float()


def _slstm_ffn(p: Params, spec: SLSTMSpec, x: torch.Tensor) -> torch.Tensor:
    """The post-block gelu FFN (a 4/3 up-projection MLP), with residual;
    split over ``ff`` as ``layers.mlp_core`` splits an MLP."""
    hf = rmsnorm(x, p["norm"], spec.norm_eps)
    return x + mlp_core({"wu": p["wff_u"], "wd": p["wff_d"]},
                        MLPSpec(spec.d_model, spec.d_ff, "gelu",
                                spec.norm_eps), hf)


def _slstm_forward(p: Params, spec: SLSTMSpec, x: torch.Tensor,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, d = x.shape
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xw = _slstm_xw(p, spec, h0)                               # [B,S,4d]
    r = p["r"].float()
    state = tuple(torch.zeros((B, d), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        state = _slstm_cell(r, spec, xw[:, t], state)
        hs.append(state[2])
    c, n, hl, m = state
    x = x + torch.stack(hs, dim=1).to(x.dtype)                # [B,S,d]
    return _slstm_ffn(p, spec, x), {"c": c, "n": n, "h": hl, "m": m}


def slstm_apply(p: Params, spec: SLSTMSpec, x: torch.Tensor) -> torch.Tensor:
    return _slstm_forward(p, spec, x)[0]


def slstm_prefill(p: Params, spec: SLSTMSpec, x: torch.Tensor,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _slstm_forward(p, spec, x)


def slstm_cache_init(spec: SLSTMSpec, batch: int, dtype,
                     device: Any) -> Dict[str, torch.Tensor]:
    d = spec.d_model
    return {k: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for k in ("c", "n", "h", "m")}


def slstm_decode(p: Params, spec: SLSTMSpec, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B,1,d]. Writes the new ``c``, ``n``, ``h``
    and ``m`` into ``cache`` IN PLACE and returns the same cache tensors."""
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xw = _slstm_xw(p, spec, h0[:, 0])
    keys = ("c", "n", "h", "m")
    new = _slstm_cell(p["r"].float(), spec, xw,
                      tuple(cache[k] for k in keys))
    x = x + new[2][:, None].to(x.dtype)
    for k, t in zip(keys, new):
        cache[k].copy_(t)
    return _slstm_ffn(p, spec, x), cache
