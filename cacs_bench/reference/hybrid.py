"""Plain reference of a hybrid Mamba / attention / MoE decoder's forward
pass over whole sequences, in float32 with TF32 off (or in a lower
precision for a control).

The served job prefills a prompt and then decodes one token a step
through its caches; this reference runs the prompt and the served tokens
as one sequence, with no cache, one layer at a time (each layer's weights
upcast from the stored dtype, used, and freed). Per layer, as the
configuration and the port describe the period:

* attention: pre-norm GQA, causal over the whole sequence, RoPE on q, k;
* Mamba-1: pre-norm, ``in_proj`` into (x, z), causal depthwise conv of
  width W with bias, SiLU, ``x_proj`` into (dt_r, B, C),
  dt = softplus(dt_r dt_proj + dt_bias), A = -exp(A_log), the recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t run step by step in float32,
  y_t = h_t C_t + D x_t, out = (y * silu(z)) out_proj;
* MoE: pre-norm, softmax router, top-k (ties to the lower expert),
  gates renormalised, each token's output the gate-weighted sum of its
  experts' SwiGLU FFNs. Over the prompt, each row's experts take at most
  ``capacity`` (token, choice) pairs in token-major, choice-minor order
  and the rest are dropped (the configuration's Switch capacity); a
  decode step's single token is never dropped;
* MLP: pre-norm SwiGLU.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from cacs_bench.reference.dense import attention, rmsnorm, rope
from cacs_bench.reference.lowp import mm

Params = Dict[str, torch.Tensor]


def capacity(seq: int, top_k: int, factor: float, experts: int) -> int:
    c = math.ceil(seq * top_k * factor / experts)
    return max(4, ((c + 3) // 4) * 4)


def _w(p: Params, name: str, group: int = 0) -> torch.Tensor:
    return p[name][group].float()


def attn_layer(p, pre, x, port, mode):
    eps, theta = port["norm_eps"], port["rope_theta"]
    R, L, d = x.shape
    wq, wk, wv, wo = (_w(p, f"{pre}.{n}") for n in ("wq", "wk", "wv", "wo"))
    norm = _w(p, f"{pre}.norm")
    pos = torch.arange(L, device=x.device)
    out = []
    for r in range(R):
        h = rmsnorm(x[r], norm, eps)
        q = mm(h, wq.reshape(d, -1), mode).view(L, *wq.shape[1:])
        k = mm(h, wk.reshape(d, -1), mode).view(L, *wk.shape[1:])
        v = mm(h, wv.reshape(d, -1), mode).view(L, *wv.shape[1:])
        o = attention(rope(q, pos, theta), rope(k, pos, theta), v, mode)
        out.append(x[r] + mm(o.reshape(L, -1), wo.reshape(-1, d), mode))
    return torch.stack(out)


def mlp_layer(p, pre, x, port, mode):
    h = rmsnorm(x, _w(p, f"{pre}.norm"), port["norm_eps"])
    return x + mm(F.silu(mm(h, _w(p, f"{pre}.wg"), mode))
                  * mm(h, _w(p, f"{pre}.wu"), mode), _w(p, f"{pre}.wd"), mode)


def mamba_layer(p, pre, x, port, mode):
    ssm = port["ssm"]
    N, W = ssm["d_state"], ssm["d_conv"]
    d = x.shape[-1]
    R_dt = max(1, math.ceil(d / 16))
    h0 = rmsnorm(x, _w(p, f"{pre}.norm"), port["norm_eps"])
    xin, z = mm(h0, _w(p, f"{pre}.in_proj"), mode).chunk(2, dim=-1)
    w, b = _w(p, f"{pre}.conv_w"), _w(p, f"{pre}.conv_b")
    xp = F.pad(xin, (0, 0, W - 1, 0))
    L = x.shape[1]
    xc = F.silu(sum(xp[:, i:i + L] * w[i] for i in range(W)) + b)
    dt_r, Bm, Cm = mm(xc, _w(p, f"{pre}.x_proj"), mode).split(
        [R_dt, N, N], dim=-1)
    dt = F.softplus(mm(dt_r, _w(p, f"{pre}.dt_proj"), mode)
                    + _w(p, f"{pre}.dt_bias"))
    A = -torch.exp(_w(p, f"{pre}.A_log"))                   # [di, N]
    h = torch.zeros(x.shape[0], xc.shape[-1], N, device=x.device)
    ys = []
    for t in range(L):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * A) * h + (dt_t * xc[:, t, :, None]) \
            * Bm[:, t, None, :]
        ys.append(torch.einsum("rdn,rn->rd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + _w(p, f"{pre}.D") * xc
    return x + mm(y * F.silu(z), _w(p, f"{pre}.out_proj"), mode)


def moe_layer(p, pre, x, port, mode, prompt_len):
    moe = port["moe"]
    E, K = moe["num_experts"], moe["top_k"]
    R, L, d = x.shape
    h = rmsnorm(x, _w(p, f"{pre}.norm"), port["norm_eps"])
    probs = torch.softmax(mm(h, _w(p, f"{pre}.router"), mode), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :K], idx[..., :K]            # [R, L, K]
    if K > 1:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    keep = torch.ones_like(gates, dtype=torch.bool)
    C = capacity(prompt_len, K, moe["capacity_factor"], E)
    chosen = experts[:, :prompt_len].cpu().tolist()
    for r in range(R):
        seen = [0] * E
        for t in range(prompt_len):
            for k in range(K):
                e = chosen[r][t][k]
                if seen[e] >= C:
                    keep[r, t, k] = False
                seen[e] += 1
    y = torch.zeros_like(x)
    flat_h = h.reshape(-1, d)
    for e in range(E):
        hit = (experts == e) & keep                         # [R, L, K]
        rows = hit.any(-1).reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gates * hit).sum(-1).reshape(-1)[rows]
        he = flat_h[rows]
        wg = p[f"{pre}.we_g"][0, e].float()
        wu = p[f"{pre}.we_u"][0, e].float()
        wd = p[f"{pre}.we_d"][0, e].float()
        out = mm(F.silu(mm(he, wg, mode)) * mm(he, wu, mode), wd, mode)
        y.view(-1, d).index_add_(0, rows, out * g[:, None])
    return x + y


def forward_logits(p: Params, blocks: List[tuple], tokens: torch.Tensor,
                   port: dict, prompt_len: int, mode: str = "f32"
                   ) -> torch.Tensor:
    """tokens [R, L] -> logits [R, L, V] (float32). ``blocks`` lists the
    period's (kind, name) in order, e.g. ("mamba", "l1_mamba")."""
    x = p["embed.embedding"][tokens.long()].float()
    for kind, name in blocks:
        pre = f"stack.{name}"
        if kind == "attn":
            x = attn_layer(p, pre, x, port, mode)
        elif kind == "mlp":
            x = mlp_layer(p, pre, x, port, mode)
        elif kind == "mamba":
            x = mamba_layer(p, pre, x, port, mode)
        elif kind == "moe":
            x = moe_layer(p, pre, x, port, mode, prompt_len)
        else:
            raise ValueError(f"no reference for a {kind} layer")
    x = rmsnorm(x, p["embed.final_norm"].float(), port["norm_eps"])
    return mm(x, p["embed.unembed"].float(), mode)


def period_blocks(port: dict) -> List[tuple]:
    """The period's layers in order, (kind, name), from the configuration:
    an attention layer every ``attn_every`` layers from layer 0 and Mamba
    between; an MoE channel mixer on every ``every``-th layer from layer
    ``every - 1`` and an MLP on the others."""
    blocks = []
    every = port["moe"]["every"]
    for j in range(port["n_layers"]):
        mixer = "attn" if j % port["attn_every"] == 0 else "mamba"
        blocks.append((mixer, f"l{j}_{mixer}"))
        chan = "moe" if j % every == every - 1 else "mlp"
        blocks.append((chan, f"l{j}_{chan}"))
    return blocks
