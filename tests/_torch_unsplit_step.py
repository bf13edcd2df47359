"""The port's one-process forward as it was before the data-parallel loss
and the model-axis split, frozen: the functions those changes rewrote,
copied as they were. ``unsplit()`` installs them for a ``with`` block,
so a test can run one train step through them and one through the
current code, in one process, and hold the two bit for bit: the changes
must leave the step outside a mesh as it was.
"""
import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import model as Mod
from repro_torch.models import moe as M


class _CrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        m = logits.amax(dim=-1, keepdim=True)
        ex = torch.exp(logits - m)
        sumexp = ex.float().sum(dim=-1)
        lse = m[..., 0].float() + torch.log(sumexp)
        tgt = torch.clamp(targets, 0, logits.shape[-1] - 1).long()
        tl = torch.gather(logits, -1, tgt[..., None])[..., 0]
        nll = lse - tl.float()
        mask = (targets >= 0).float()
        n = torch.clamp_min(mask.sum(), 1.0)
        loss = (nll * mask).sum() / n
        ctx.save_for_backward(ex, sumexp, tgt, mask, n)
        return loss

    @staticmethod
    def backward(ctx, g):
        ex, sumexp, tgt, mask, n = ctx.saved_tensors
        dt = ex.dtype
        inv = (1.0 / sumexp).to(dt)[..., None]
        scale = (g * mask / n).to(dt)[..., None]
        vocab = torch.arange(ex.shape[-1], device=ex.device)
        onehot = (tgt[..., None] == vocab).to(dt)
        return (ex * inv - onehot) * scale, None


def cross_entropy(logits, targets, vocab=None):
    return _CrossEntropy.apply(logits, targets)


def attn_apply(p, spec, x, *, positions, memory=None):
    if spec.cross:
        mk, mv = memory
        h = L.rmsnorm(x, p["norm"], spec.norm_eps)
        out = L.attention_ref(L._proj(h, p["wq"]), mk, mv, causal=False)
    else:
        h = L.rmsnorm(x, p["norm"], spec.norm_eps)
        q, k, v = L._proj(h, p["wq"]), L._proj(h, p["wk"]), L._proj(h, p["wv"])
        if spec.use_rope:
            q = L.apply_rope(q, positions, spec.rope_theta)
            k = L.apply_rope(k, positions, spec.rope_theta)
        out = L.attention_ref(q, k, v, causal=spec.causal, window=spec.window,
                              q_positions=positions, kv_positions=positions)
    return x + L._out_proj(out, p["wo"])


def mlp_core(p, spec, h):
    if spec.act == "swiglu":
        return (F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    if spec.act == "squared_relu":
        return torch.square(F.relu(h @ p["wu"])) @ p["wd"]
    if spec.act == "gelu":
        return F.gelu(h @ p["wu"], approximate="tanh") @ p["wd"]
    raise ValueError(spec.act)


def mlp_apply(p, spec, x):
    h = L.rmsnorm(x, p["norm"], spec.norm_eps)
    return x + mlp_core(p, spec, h)


def embed_apply(p, tokens, dtype, vocab=None):
    emb = p["embedding"]
    out = torch.index_select(emb, 0, tokens.reshape(-1))
    return out.reshape(*tokens.shape, emb.shape[-1]).to(dtype)


def unembed_apply(p, x, tie, vocab=None):
    if tie:
        return torch.matmul(x, p["embedding"].t())
    return torch.matmul(x, p["unembed"])


def moe_apply(p, spec, x):
    m = spec.cfg
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    C = M.moe_capacity(S, m)
    dt, dev = x.dtype, x.device
    h = L.rmsnorm(x, p["norm"], spec.norm_eps)
    logits = (h @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = M.top_k(probs, K)
    if K > 1:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    flat_idx = expert_idx.reshape(B, S * K)
    onehot = F.one_hot(flat_idx, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos, 2, flat_idx[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, flat_idx * C + pos, E * C)
    order = torch.arange(S * K, device=dev)
    dest = torch.where(keep, slot, E * C + order)
    token_src = torch.zeros((B, E * C + S * K), dtype=torch.long,
                            device=dev).scatter(
        1, dest, (order + 1).expand(B, S * K))[:, :E * C]
    src_s = torch.clamp(torch.div(token_src - 1, K, rounding_mode="floor"),
                        0, S - 1)
    x_e = torch.gather(h, 1, src_s[..., None].expand(B, E * C, d))
    x_e = x_e * (token_src > 0)[..., None].to(dt)
    x_e = x_e.reshape(B, E, C, d)
    y_e = M._expert_ffn(p, spec.act, x_e).reshape(B, E * C, d)
    slot_c = torch.clamp(slot, 0, E * C - 1)
    y_tok = torch.gather(y_e, 1, slot_c[..., None].expand(B, S * K, d))
    scale = (keep.float() * gates.reshape(B, S * K)).to(dt)[..., None]
    y_tok = y_tok * scale
    if K == 1:
        y = y_tok.reshape(B, S, d)
    else:
        y = y_tok.reshape(B, S, K, d).sum(dim=2)
    if spec.d_ff_shared > 0:
        shared = {"wg": p.get("ws_g"), "wu": p["ws_u"], "wd": p["ws_d"]}
        y = y + mlp_core(shared, L.MLPSpec(spec.d_model, spec.d_ff_shared,
                                           spec.act, spec.norm_eps), h)
    frac_tokens = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux = (frac_tokens * mean_probs).sum() * E
    return x + y, aux


_FROZEN = [(Mod, "cross_entropy", cross_entropy),
           (L, "attn_apply", attn_apply), (L, "mlp_apply", mlp_apply),
           (L, "embed_apply", embed_apply),
           (L, "unembed_apply", unembed_apply), (M, "moe_apply", moe_apply)]


@contextlib.contextmanager
def unsplit():
    """The frozen functions in place of the current ones, for the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _FROZEN]
    try:
        for mod, name, fn in _FROZEN:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
