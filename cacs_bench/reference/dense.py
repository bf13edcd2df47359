"""Plain reference of a dense GQA decoder's training step: forward, loss,
backward and AdamW, in float32 with TF32 off (or in a lower precision for
a control).

The parameters arrive as the benchmark drew them, a flat dict of
``"embed.embedding"``-style names to stacked ``[n_layers, ...]`` tensors
in the stored dtype; the reference upcasts them to float32 for the step,
and rounds the updated parameters back to the stored dtype, as the
configuration stores them. The step follows the published description:

    x = E[tokens]
    per layer:  x += Wo . attn(RoPE(Wq n(x)), RoPE(Wk n(x)), Wv n(x))
                x += Wd (silu(Wg n(x)) * Wu n(x))
    logits = n(x) . U;   loss = mean CE over targets >= 0

with n the RMSNorm, grouped-query causal attention (query head h reads kv
head h // (H / Hkv)) and the rotate-half RoPE. The batch runs a row at a
time with each layer recomputed in the backward, so the peak stays a
layer's; the gradients are summed over the rows exactly as one batch
gives them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cacs_bench.reference.lowp import mm

Params = Dict[str, torch.Tensor]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; rotate-half form over the two halves of hd."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mode: str) -> torch.Tensor:
    """Causal GQA. q [S, H, hd], k/v [T, Hkv, hd] with T = S."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = mm(q.transpose(0, 1), k.permute(1, 2, 0), mode) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, v.transpose(0, 1), mode).transpose(0, 1)


def attn_block(x, norm, wq, wk, wv, wo, *, eps, theta, mode):
    S, d = x.shape
    h = rmsnorm(x, norm, eps)
    q = mm(h, wq.reshape(d, -1), mode).view(S, wq.shape[1], wq.shape[2])
    k = mm(h, wk.reshape(d, -1), mode).view(S, wk.shape[1], wk.shape[2])
    v = mm(h, wv.reshape(d, -1), mode).view(S, wv.shape[1], wv.shape[2])
    pos = torch.arange(S, device=x.device)
    o = attention(rope(q, pos, theta), rope(k, pos, theta), v, mode)
    return x + mm(o.reshape(S, -1), wo.reshape(-1, d), mode)


def mlp_block(x, norm, wg, wu, wd, *, eps, mode):
    h = rmsnorm(x, norm, eps)
    return x + mm(F.silu(mm(h, wg, mode)) * mm(h, wu, mode), wd, mode)


def row_nll(p: Params, tokens: torch.Tensor, targets: torch.Tensor,
            port: dict, mode: str) -> torch.Tensor:
    """Σ nll over one row's targets >= 0 (float32 scalar)."""
    eps, theta = port["norm_eps"], port["rope_theta"]
    x = p["embed.embedding"][tokens.long()]
    for i in range(port["n_layers"]):
        a = [p[f"stack.l0_attn.{n}"][i]
             for n in ("norm", "wq", "wk", "wv", "wo")]
        x = checkpoint(lambda x, *w: attn_block(
            x, *w, eps=eps, theta=theta, mode=mode), x, *a,
            use_reentrant=False)
        m = [p[f"stack.l0_mlp.{n}"][i] for n in ("norm", "wg", "wu", "wd")]
        x = checkpoint(lambda x, *w: mlp_block(x, *w, eps=eps, mode=mode),
                       x, *m, use_reentrant=False)
    x = rmsnorm(x, p["embed.final_norm"], eps)
    logits = mm(x, p["embed.unembed"], mode)
    keep = targets >= 0
    nll = -torch.log_softmax(logits, dim=-1)[
        keep.nonzero()[:, 0], targets[keep].long()]
    return nll.sum()


def lr_at(opt: dict, step: int) -> float:
    warm = min((step + 1.0) / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    if opt["schedule"] == "cosine":
        decay = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
            1 + math.cos(math.pi * frac))
    elif opt["schedule"] == "linear":
        decay = 1.0 - (1 - opt["min_lr_frac"]) * frac
    else:
        decay = 1.0
    return opt["lr"] * warm * decay


def decays(name: str) -> bool:
    """Weight decay on every matrix and on the per-layer norm weights,
    which the stacked layout holds as [n_layers, d]; not on the final
    norm."""
    return name != "embed.final_norm"


def train(p0: Params, batches: List[tuple], port: dict, opt: dict, *,
          mode: str = "f32", rows: Optional[int] = None,
          keep_state: bool = False) -> dict:
    """Run ``len(batches)`` AdamW steps from ``p0`` (stored dtype).

    ``rows``: use only the first ``rows`` rows of each batch (a fault:
    half of the batch left out, the mean taken over the rest).
    Returns the loss of each step, each leaf's norm of the first step's
    gradient as AdamW takes it (after clipping) and before clipping, and
    each leaf's norm of the change of the stored parameters after the
    last step.
    """
    names = sorted(p0)
    stored = {n: p0[n].clone() for n in names}
    m = {n: torch.zeros(p0[n].shape, dtype=torch.float32,
                        device=p0[n].device) for n in names}
    v = {n: torch.zeros_like(m[n]) for n in names}
    losses, g1, g1_raw = [], {}, {}
    for step, (tokens, targets) in enumerate(batches):
        tokens = torch.as_tensor(tokens, device=p0[names[0]].device)
        targets = torch.as_tensor(targets, device=tokens.device)
        if rows is not None:
            tokens, targets = tokens[:rows], targets[:rows]
        count = float((targets >= 0).sum())
        p32 = {n: stored[n].float().requires_grad_() for n in names}
        grads = {n: torch.zeros_like(m[n]) for n in names}
        total = 0.0
        for r in range(tokens.shape[0]):
            nll = row_nll(p32, tokens[r], targets[r], port, mode) / count
            gs = torch.autograd.grad(nll, [p32[n] for n in names])
            for n, g in zip(names, gs):
                grads[n] += g
            total += float(nll.detach())
        losses.append(total)
        gnorm = math.sqrt(sum(float(g.square().sum())
                              for g in grads.values()))
        scale = (opt["grad_clip"] / (gnorm + 1e-9)
                 if opt["grad_clip"] > 0 and gnorm > opt["grad_clip"]
                 else 1.0)
        lr = lr_at(opt, step)
        c = step + 1
        bc1, bc2 = 1 - opt["b1"] ** c, 1 - opt["b2"] ** c
        with torch.no_grad():
            for n in names:
                g = grads[n] * scale
                if step == 0:
                    g1[n] = float(g.norm())
                    g1_raw[n] = float(grads[n].norm())
                m[n] = opt["b1"] * m[n] + (1 - opt["b1"]) * g
                v[n] = opt["b2"] * v[n] + (1 - opt["b2"]) * g * g
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                p = p32[n].detach()
                if decays(n):
                    upd = upd + opt["weight_decay"] * p
                stored[n] = (p - lr * upd).to(p0[n].dtype)
        del p32, grads
    delta = {n: float((stored[n].float() - p0[n].float()).norm())
             for n in names}
    out = {"losses": losses, "grad1": g1, "grad1_raw": g1_raw,
           "delta": delta}
    if keep_state:
        out["state"] = {**{f"params.{n}": t for n, t in stored.items()},
                        **{f"opt_state.m.{n}": t for n, t in m.items()},
                        **{f"opt_state.v.{n}": t for n, t in v.items()}}
    return out
