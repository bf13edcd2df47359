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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import ParamBuilder, rmsnorm

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


def _ssm_inputs(p: Params, spec: MambaSpec, x: torch.Tensor):
    """x: [B,S,di] (post-conv, post-silu) -> (dA [B,S,di,N], bx, C)."""
    N, R = spec.cfg.d_state, spec.dt_rank
    xdb = x @ p["x_proj"]                                     # [B,S,R+2N]
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
    di, N = spec.d_inner, spec.cfg.d_state
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xin, z = torch.chunk(h0 @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dA, bx, Cm = _ssm_inputs(p, spec, xc)

    nc = max(1, S // CHUNK)
    Q = S // nc
    if nc * Q != S:       # the reference asserts the same
        raise AssertionError(f"seq {S} not divisible into chunks of {Q}")

    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        a_cum, b_cum = _chunk_scan(torch.exp(dA[:, sl]), bx[:, sl])
        h_all = a_cum * h[:, None] + b_cum                    # [B,Q,di,N]
        ys.append(torch.einsum("bqdn,bqn->bqd", h_all, Cm[:, sl]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)                                  # [B,S,di]
    y = (y + p["D"].float() * xc.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return x + out, {"h": h, "conv": conv_state}


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
    into ``cache`` IN PLACE and returns the same cache tensors."""
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    xin, z = torch.chunk(h0 @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  cache["conv"])
    xc = F.silu(xc)
    dA, bx, Cm = _ssm_inputs(p, spec, xc)                     # S=1
    h_new = torch.exp(dA[:, 0]) * cache["h"] + bx[:, 0]       # [B,di,N]
    y = torch.einsum("bdn,bn->bd", h_new, Cm[:, 0])[:, None]
    y = (y + p["D"].float() * xc.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return x + out, cache
