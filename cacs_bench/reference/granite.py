"""Plain reference of granite-4.0-h's forward pass over whole sequences, in
float32 with TF32 off (or in a lower precision for a control).

The served job prefills a prompt and then decodes one token a step
through its caches; this reference runs the prompt and the served tokens
as one sequence, with no cache, one layer at a time (each layer's weights
upcast from the stored dtype, used, and freed). The equations are those of
transformers' ``modeling_granitemoehybrid.py``:

* the token embeddings times ``embedding_multiplier``;
* each layer: x + residual_multiplier * mixer(rmsnorm(x)), then
  x + residual_multiplier * (moe(h) + shared_mlp(h)), h = rmsnorm(x);
* attention (layer j of a period with j == ``attn_offset``): GQA, causal,
  no positional encoding, the scores times ``attn_scale``;
* Mamba-2 (the other layers): ``in_proj`` into [z | xBC | dt]; a causal
  depthwise conv of ``d_conv`` taps with bias over xBC, SiLU; x, B, C;
  dt = softplus(dt + dt_bias), A = -exp(A_log); h_t = exp(dt_t A) h_{t-1}
  + dt_t x_t ⊗ B_t and y_t = C_t · h_t + D x_t; y · silu(z), RMSNorm over
  all d_inner channels times its weight; ``out_proj``;
* MoE: the top ``top_k`` router logits, softmax over them; each token's
  output the gate-weighted sum of its experts' SwiGLU FFNs, none dropped;
  the shared SwiGLU MLP added;
* the final RMSNorm, the tied head, the logits divided by
  ``logits_scaling``.

Departures from the upstream file, none of which changes a number in exact
arithmetic: weights in the benchmark's layout (matrices as [in, out]; each
expert's gate and up projections apart, ``we_g`` and ``we_u``, and the
shared MLP's, ``ws_g`` and ``ws_u``, where upstream fuses each pair);
the conv as a sum over its taps; the scan in chunks of ``chunk`` steps in
the SSD form, carrying the state between chunks (held to the step-by-step
recurrence by the CPU tests of ``tests/test_torch_granite.py``, whose
reference runs it step by step); the padded vocabulary's pad rows' logits
left in (the served tokens never are one).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from cacs_bench.reference.dense import rmsnorm
from cacs_bench.reference.lowp import mm

Params = Dict[str, torch.Tensor]


def _w(p: Params, name: str, group: int) -> torch.Tensor:
    return p[name][group].float()


def attention(p, pre, g, x, port, mode):
    """Causal GQA without a positional encoding, a row at a time."""
    R, L, d = x.shape
    H, Hkv = port["n_heads"], port["n_kv_heads"]
    hd = d // H
    wq, wk, wv, wo = (_w(p, f"{pre}.{n}", g) for n in ("wq", "wk", "wv",
                                                         "wo"))
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    out = []
    for r in range(R):
        q = mm(x[r], wq.reshape(d, -1), mode).view(L, H, hd).transpose(0, 1)
        k = mm(x[r], wk.reshape(d, -1), mode).view(L, Hkv, hd)
        v = mm(x[r], wv.reshape(d, -1), mode).view(L, Hkv, hd)
        k = k.repeat_interleave(H // Hkv, dim=1).permute(1, 2, 0)
        v = v.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)
        s = mm(q, k, mode) * port["attn_scale"]
        s = s.masked_fill(~mask, float("-inf"))
        o = mm(torch.softmax(s, dim=-1), v, mode).transpose(0, 1)
        out.append(mm(o.reshape(L, -1), wo.reshape(-1, d), mode))
    return torch.stack(out)


def ssd(x, dt, A, Bm, Cm, chunk):
    """The Mamba-2 scan in f32, chunk by chunk: x [R,L,H,P], dt [R,L,H],
    A [H], Bm, Cm [R,L,G,N] -> y [R,L,H,P] = C_t · h_t."""
    R, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    E = H // G
    h = torch.zeros(R, G, E, P, N, device=x.device)
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(L, c0 + chunk))
        Q = sl.stop - sl.start
        s = torch.cumsum((dt[:, sl] * A).view(R, Q, G, E), dim=1)
        xdt = (x[:, sl] * dt[:, sl, :, None]).view(R, Q, G, E, P)
        Bc, Cc = Bm[:, sl], Cm[:, sl]
        sp = s.permute(0, 2, 3, 1)
        live = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp((sp[..., :, None] - sp[..., None, :]).masked_fill(
            ~live, float("-inf")))
        cb = torch.einsum("rign,rjgn->rgij", Cc, Bc)
        y = torch.einsum("rgeij,rjgep->rigep", decay * cb[:, :, None], xdt)
        y = y + torch.exp(s)[..., None] * torch.einsum(
            "rign,rgepn->rigep", Cc, h)
        ys.append(y.reshape(R, Q, H, P))
        last = s[:, -1]
        w = torch.exp(last[:, None] - s)[..., None] * xdt
        h = (torch.exp(last)[..., None, None] * h
             + torch.einsum("rjgep,rjgn->rgepn", w, Bc))
    return torch.cat(ys, dim=1)


def mamba2(p, pre, g, x, port, mode):
    s = port["ssm"]
    R, L, d = x.shape
    di = s["expand"] * d
    H, P, G, N, W = (s["n_heads"], s["head_dim"], s["n_groups"],
                     s["d_state"], s["d_conv"])
    z, xbc, dt = mm(x, _w(p, f"{pre}.in_proj", g), mode).split(
        [di, di + 2 * G * N, H], dim=-1)
    w, b = _w(p, f"{pre}.conv_w", g), _w(p, f"{pre}.conv_b", g)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = F.silu(sum(xp[:, i:i + L] * w[i] for i in range(W)) + b)
    xs, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
    xs = xs.reshape(R, L, H, P)
    dt = F.softplus(dt + _w(p, f"{pre}.dt_bias", g))
    A = -torch.exp(_w(p, f"{pre}.A_log", g))
    y = ssd(xs, dt, A, Bm.reshape(R, L, G, N), Cm.reshape(R, L, G, N),
            s["chunk"])
    y = (y + _w(p, f"{pre}.D", g)[:, None] * xs).reshape(R, L, di)
    y = rmsnorm(y * F.silu(z), _w(p, f"{pre}.gate_norm", g),
                port["norm_eps"])
    return mm(y, _w(p, f"{pre}.out_proj", g), mode)


def swiglu(h, wg, wu, wd, mode):
    return mm(F.silu(mm(h, wg, mode)) * mm(h, wu, mode), wd, mode)


def moe(p, pre, g, h, port, mode):
    """Every (token, choice) pair through its expert, then the shared
    MLP."""
    m = port["moe"]
    R, L, d = h.shape
    flat = h.reshape(-1, d)
    vals, idx = torch.topk(mm(flat, _w(p, f"{pre}.router", g), mode),
                           m["top_k"], dim=-1)
    gates = torch.softmax(vals, dim=-1)
    y = torch.zeros_like(flat)
    for e in range(m["num_experts"]):
        rows, k = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ws = [p[f"{pre}.{n}"][g, e].float() for n in ("we_g", "we_u",
                                                       "we_d")]
        y.index_add_(0, rows, swiglu(flat[rows], *ws, mode)
                     * gates[rows, k][:, None])
    shared = [_w(p, f"{pre}.{n}", g) for n in ("ws_g", "ws_u", "ws_d")]
    return (y + swiglu(flat, *shared, mode)).reshape(R, L, d)


def forward_logits(p: Params, tokens: torch.Tensor, port: dict,
                   mode: str = "f32") -> torch.Tensor:
    """tokens [R, L] -> logits [R, L, V] (float32)."""
    eps, res = port["norm_eps"], port["residual_multiplier"]
    period, offset = port["attn_every"], port["attn_offset"]
    x = p["embed.embedding"][tokens.long()].float() \
        * port["embedding_multiplier"]
    for j in range(port["n_layers"]):
        g, jj = divmod(j, period)
        kind = "attn" if jj == offset else "mamba2"
        pre = f"stack.l{jj}_{kind}"
        mix = attention if kind == "attn" else mamba2
        x = x + res * mix(p, pre, g, rmsnorm(x, _w(p, f"{pre}.norm", g), eps),
                          port, mode)
        pre = f"stack.l{jj}_moe"
        x = x + res * moe(p, pre, g, rmsnorm(x, _w(p, f"{pre}.norm", g), eps),
                          port, mode)
    x = rmsnorm(x, p["embed.final_norm"].float(), eps)
    return mm(x, p["embed.embedding"].float().t(), mode) \
        / port["logits_scaling"]
