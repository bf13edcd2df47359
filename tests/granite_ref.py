"""Plain reference of granite-4.0-h's forward pass, for the tests of the
port's granite model (``tests/test_torch_granite.py``).

float32 throughout (the tests turn TF32 off), one sequence at a time, no
cache and no kernel: the equations of transformers'
``modeling_granitemoehybrid.py`` written out.

* The embedding lookup times ``embedding_multiplier``.
* Each layer: ``x + residual_multiplier * mixer(rmsnorm(x))``, then
  ``x + residual_multiplier * (moe(h) + shared_mlp(h))`` with
  ``h = rmsnorm(x)``.
* Attention (layer ``j`` with ``j % attn_every == attn_offset``): GQA,
  causal, no positional encoding, scores times ``attn_scale``.
* Mamba-2 (the other layers): ``in_proj`` into [z | xBC | dt]; a causal
  depthwise conv of ``d_conv`` taps with bias over xBC, SiLU; x, B, C;
  dt = softplus(dt + dt_bias), A = -exp(A_log); the recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t and y_t = C_t · h_t + D x_t,
  step by step; y · silu(z), RMSNorm over all d_inner channels times its
  weight; ``out_proj``.
* MoE: router logits, the top ``top_k`` of them, softmax over those;
  each token's output the gate-weighted sum of its experts' SwiGLU FFNs
  (none dropped); the shared SwiGLU MLP added.
* The final RMSNorm, the tied head, the logits divided by
  ``logits_scaling``.

Departures from the upstream file, none of which changes a number in
exact arithmetic: weights are read in the port's layout (matrices as [in,
out]; each expert's gate and up projections as ``we_g``, ``we_u`` where
upstream fuses them into ``input_linear``, the shared MLP's as ``ws_g``,
``ws_u``; the leaves of one period's layers stacked over the periods);
the conv runs as a sum over its taps; the SSD scan is the step-by-step
recurrence that upstream's chunked form computes; the decode cache and
padding masks are absent; the vocabulary is the port's padded one (the
pad rows' logits are left in).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def attention(p, x, cfg) -> torch.Tensor:
    L, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(d, -1)).view(L, H, hd)
    k = (x @ p["wk"].reshape(d, -1)).view(L, Hkv, hd)
    v = (x @ p["wv"].reshape(d, -1)).view(L, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scale = cfg.attn_scale if cfg.attn_scale is not None \
        else 1.0 / math.sqrt(hd)
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    s = s.masked_fill(~mask, -math.inf)
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return o.reshape(L, H * hd) @ p["wo"].reshape(H * hd, d)


def mamba2(p, x, cfg) -> torch.Tensor:
    s = cfg.ssm
    L = x.shape[0]
    di = s.expand * cfg.d_model
    H, P, G, N, W = s.n_heads, s.head_dim, s.n_groups, s.d_state, s.d_conv
    z, xbc, dt = torch.split(x @ p["in_proj"], [di, di + 2 * G * N, H], -1)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = F.silu(sum(xp[i:i + L] * p["conv_w"][i] for i in range(W))
                 + p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], -1)
    xs = xs.view(L, H, P)
    Bm = Bm.view(L, G, N).repeat_interleave(H // G, dim=1)     # [L, H, N]
    Cm = Cm.view(L, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + p["dt_bias"])                         # [L, H]
    A = -torch.exp(p["A_log"])
    h = torch.zeros(H, P, N)
    ys = []
    for t in range(L):
        h = (torch.exp(dt[t] * A)[:, None, None] * h
             + (dt[t][:, None] * xs[t])[..., None] * Bm[t][:, None, :])
        ys.append(torch.einsum("hpn,hn->hp", h, Cm[t])
                  + p["D"][:, None] * xs[t])
    y = torch.stack(ys).reshape(L, di) * F.silu(z)
    return rmsnorm(y, p["gate_norm"], cfg.norm_eps) @ p["out_proj"]


def swiglu(x, wg, wu, wd) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def moe(p, x, cfg) -> torch.Tensor:
    m = cfg.moe
    vals, idx = torch.topk(x @ p["router"], m.top_k, dim=-1)
    gates = torch.softmax(vals, dim=-1)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for k in range(m.top_k):
            e = int(idx[t, k])
            out[t] += gates[t, k] * swiglu(x[t], p["we_g"][e], p["we_u"][e],
                                           p["we_d"][e])
    return out + swiglu(x, p["ws_g"], p["ws_u"], p["ws_d"])


def layer(params: Any, j: int, cfg) -> tuple:
    """(kind, params of layer ``j``'s mixer, of its MoE): group j //
    period of the stacked leaves."""
    period = cfg.attn_every
    g, jj = divmod(j, period)
    kind = "attn" if jj == cfg.attn_offset else "mamba2"
    take = lambda name: {k: t[g].float()
                         for k, t in params["stack"][name].items()}
    return kind, take(f"l{jj}_{kind}"), take(f"l{jj}_moe")


@torch.no_grad()
def forward_logits(params: Any, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [L] (one sequence) -> logits [L, padded vocab], float32."""
    if cfg.use_rope:
        raise ValueError("the reference has no positional encoding")
    emb = params["embed"]["embedding"].float()
    x = emb[tokens.long()] * cfg.embedding_multiplier
    r, eps = cfg.residual_multiplier, cfg.norm_eps
    for j in range(cfg.n_layers):
        kind, pm, pe = layer(params, j, cfg)
        mix = attention if kind == "attn" else mamba2
        x = x + r * mix(pm, rmsnorm(x, pm["norm"], eps), cfg)
        x = x + r * moe(pe, rmsnorm(x, pe["norm"], eps), cfg)
    x = rmsnorm(x, params["embed"]["final_norm"].float(), eps)
    return (x @ emb.t()) / cfg.logits_scaling
