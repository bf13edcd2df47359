"""Mamba-1 selective SSM block (jamba's recurrent layer).

Port of ``repro/models/ssm.py``. The selective scan is *chunked* as in
the reference: a loop over chunks of ``CHUNK`` steps carrying one
``[B, d_inner, N]`` f32 state, with a log-depth scan inside each chunk.
The reference's in-chunk ``lax.associative_scan`` becomes a Hillis–Steele
doubling over the chunk axis with the same combine,
``(a1, b1) . (a2, b2) = (a1*a2, a2*b1 + b2)``; the two combine in
different orders, so in f32 they agree to rounding, not bit for bit.
This is plain PyTorch, as the reference is plain XLA (no Pallas kernel).
Decode is a one-step recurrence that writes the new ``h`` and ``conv``
into the cache in place, as ``attn_decode`` writes slot ``pos``.

Under ``sharding.specs.activation_sharding(axes, mesh)`` with a model
axis that divides ``d_inner``, the block is split as ``leaf_spec`` lays
its params out and as GSPMD splits the reference's: ``in_proj``
column-parallel over its contiguous columns, then one all-to-all
(``specs.relayout_halves``) so that each rank holds ``xin`` and ``z``
for its ``d_inner / tp`` channels; the conv, ``dt_proj``
(column-parallel), the gates and the chunked scan (per channel) on those
channels; ``x_proj`` row-parallel, its ``[B,S,R+2N]`` partial sums
all-reduced (and their gradient too: every rank's channels read the
sum); ``out_proj`` row-parallel and all-reduced. ``conv_w``, ``conv_b``,
``dt_bias``, ``A_log`` and ``D`` are whole on every rank
(``ssm_inner_nt``): each rank takes its slice of ``copy_to_tp(w)``, so
their gradient is summed over the ranks. The decode runs the same at
S = 1 on the rank's slices of ``h`` [B, d_inner/tp, N] and ``conv``
[B, W-1, d_inner/tp] (``cache_dims``' ``ssm_inner`` layout).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import ParamBuilder, rmsnorm
from repro_torch.sharding import specs as SH

Params = Any
CHUNK = 256


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    cfg: SSMConfig
    norm_eps: float

    @property
    def d_inner(self) -> int:
        return self.cfg.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))


def mamba_init(b: ParamBuilder, spec: MambaSpec) -> None:
    d, di, R, N = spec.d_model, spec.d_inner, spec.dt_rank, spec.cfg.d_state
    W = spec.cfg.d_conv
    b.add("norm", (d,), ("embed_nt",), init="ones")
    b.add("in_proj", (d, 2 * di), ("embed", "ssm_inner"))
    b.add("conv_w", (W, di), (None, "ssm_inner_nt"), scale=1.0 / math.sqrt(W))
    b.add("conv_b", (di,), ("ssm_inner_nt",), init="zeros")
    b.add("x_proj", (di, R + 2 * N), ("ssm_inner", None))
    b.add("dt_proj", (R, di), (None, "ssm_inner"), scale=1.0 / math.sqrt(R))
    b.add("dt_bias", (di,), ("ssm_inner_nt",), init="zeros")
    b.add("A_log", (di, N), ("ssm_inner_nt", None), init="zeros")
    b.add("D", (di,), ("ssm_inner_nt",), init="ones")
    b.add("out_proj", (di, d), ("ssm_inner", "embed"),
          scale=1.0 / math.sqrt(di))


def inner_split(name: str, d: int, n: int, parts: int) -> Optional[slice]:
    """This rank's channels of an inner width ``n`` whose fused input
    projection ``[d, parts·n]`` (dims ``("embed", name)``) ``leaf_spec``
    splits over the model axis; ``None`` outside a split context or
    where the projection stays whole (the block then runs whole on every
    rank)."""
    tp = SH.tp_size()
    if tp == 1 or SH.active_leaf_spec(("embed", name),
                                      (d, parts * n))[1] is None:
        return None
    if n % tp:
        raise ValueError(f"{name} of {n} channels does not split over "
                         f"{tp} ranks, though its fused projection does")
    k = n // tp
    r = SH.tp_rank()
    return slice(r * k, (r + 1) * k)


def whole_slices(ws: Sequence[torch.Tensor], dims: Sequence[int],
                 ch: slice) -> List[torch.Tensor]:
    """This rank's channels ``ch`` (along ``dims``) of leaves whole on
    every rank, taken from one ``copy_to_tp`` of them packed together:
    their gradients, a part on each rank, are summed over the ranks in
    one all-reduce."""
    flat = SH.copy_to_tp(torch.cat([w.reshape(-1) for w in ws]))
    out, o = [], 0
    for w, d in zip(ws, dims):
        out.append(flat[o:o + w.numel()].view(w.shape).narrow(
            d, ch.start, ch.stop - ch.start))
        o += w.numel()
    return out


_PER_CHANNEL = (("conv_w", -1), ("conv_b", -1), ("dt_bias", -1),
                ("A_log", 0), ("D", -1))


def _local(p: Params, spec: MambaSpec) -> Tuple[Params, Optional[slice]]:
    """The params as this rank uses them: in a split context the whole
    per-channel leaves narrowed to its channels."""
    ch = inner_split("ssm_inner", spec.d_model, spec.d_inner, 2)
    if ch is None:
        return p, None
    names, dims = zip(*_PER_CHANNEL)
    return {**p, **dict(zip(names, whole_slices(
        [p[k] for k in names], dims, ch)))}, ch


def in_halves(h0: torch.Tensor, w: torch.Tensor, split: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two halves of a fused input projection ``h0 @ w``; split, the
    rank's columns exchanged into its channels of each half."""
    if not split:
        return torch.chunk(h0 @ w, 2, dim=-1)
    return SH.relayout_halves(SH.copy_to_tp(h0) @ w)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,S,di]; w: [W,di]. Returns (y, new_state).

    state: [B, W-1, di] — trailing inputs from the previous segment. The
    taps are summed in the reference's order, in the compute dtype.
    """
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    return y, xp[:, -(W - 1):]


def _ssm_inputs(p: Params, spec: MambaSpec, x: torch.Tensor,
                split: bool = False):
    """x: [B,S,di] (post-conv, post-silu) -> (dA [B,S,di,N], bx, C).
    Split: x is the rank's channels and ``x_proj``'s partial sums are
    added up over the ranks."""
    N, R = spec.cfg.d_state, spec.dt_rank
    xdb = x @ p["x_proj"]                                     # [B,S,R+2N]
    if split:
        xdb = SH.copy_to_tp(SH.reduce_from_tp(xdb))
    dt_r, Bm, Cm = torch.split(xdb, [R, N, N], dim=-1)
    # softplus in the compute dtype, then f32, as the reference orders it
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()  # [B,S,di]
    A = -torch.exp(p["A_log"].float())                        # [di,N]
    dA = dt[..., None] * A                                    # [B,S,di,N]
    bx = (dt * x.float())[..., None] * Bm.float()[:, :, None, :]
    return dA, bx, Cm.float()


def _chunk_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` pairs over dim 1 by doubling: after the
    step of offset ``o`` each position holds the combine of the ``2o``
    pairs ending at it, left (earlier) operand first."""
    o, Q = 1, a.shape[1]
    while o < Q:
        a_l, b_l = a[:, :Q - o], b[:, :Q - o]
        a_r, b_r = a[:, o:], b[:, o:]
        b = torch.cat([b[:, :o], a_r * b_l + b_r], dim=1)
        a = torch.cat([a[:, :o], a_l * a_r], dim=1)
        o *= 2
    return a, b


def _mamba_forward(p: Params, spec: MambaSpec, x: torch.Tensor,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shared train/prefill forward. Returns (out, cache)."""
    B, S, _ = x.shape
    N = spec.cfg.d_state
    p, ch = _local(p, spec)
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xin, z = in_halves(h0, p["in_proj"], ch is not None)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dA, bx, Cm = _ssm_inputs(p, spec, xc, ch is not None)

    nc = max(1, S // CHUNK)
    Q = S // nc
    if nc * Q != S:       # the reference asserts the same
        raise AssertionError(f"seq {S} not divisible into chunks of {Q}")

    h = torch.zeros((B, xc.shape[-1], N), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        a_cum, b_cum = _chunk_scan(torch.exp(dA[:, sl]), bx[:, sl])
        h_all = a_cum * h[:, None] + b_cum                    # [B,Q,di,N]
        ys.append(torch.einsum("bqdn,bqn->bqd", h_all, Cm[:, sl]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)                                  # [B,S,di]
    y = (y + p["D"].float() * xc.float()).to(x.dtype)
    return x + _out(p, y, z, ch), {"h": h, "conv": conv_state}


def _out(p: Params, y: torch.Tensor, z: torch.Tensor,
         ch: Optional[slice]) -> torch.Tensor:
    """The gated output projection; split, its partial sums added up."""
    out = (y * F.silu(z)) @ p["out_proj"]
    return out if ch is None else SH.reduce_from_tp(out)


def mamba_apply(p: Params, spec: MambaSpec, x: torch.Tensor) -> torch.Tensor:
    """Training forward. x: [B,S,d] -> [B,S,d] (with residual)."""
    return _mamba_forward(p, spec, x)[0]


def mamba_prefill(p: Params, spec: MambaSpec, x: torch.Tensor,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _mamba_forward(p, spec, x)


def mamba_cache_init(spec: MambaSpec, batch: int, dtype,
                     device: Any) -> Dict[str, torch.Tensor]:
    di, N, W = spec.d_inner, spec.cfg.d_state, spec.cfg.d_conv
    return {
        "h": torch.zeros((batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, W - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p: Params, spec: MambaSpec, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B,1,d]. Writes the new ``h`` and ``conv``
    into ``cache`` IN PLACE and returns the same cache tensors (split:
    this rank's slices of them)."""
    p, ch = _local(p, spec)
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xin, z = in_halves(h0, p["in_proj"], ch is not None)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  cache["conv"])
    xc = F.silu(xc)
    dA, bx, Cm = _ssm_inputs(p, spec, xc, ch is not None)     # S=1
    h_new = torch.exp(dA[:, 0]) * cache["h"] + bx[:, 0]       # [B,di,N]
    y = torch.einsum("bdn,bn->bd", h_new, Cm[:, 0])[:, None]
    y = (y + p["D"].float() * xc.float()).to(x.dtype)
    out = _out(p, y, z, ch)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return x + out, cache
