"""The port's one-process forward as it was before the data-parallel loss
and the model-axis split (of the attention, MLP and MoE blocks, then of
the Mamba and xLSTM blocks), frozen: the functions those changes
rewrote, copied as they were. ``unsplit()`` installs them for a ``with`` block,
so a test can run one train step through them and one through the
current code, in one process, and hold the two bit for bit: the changes
must leave the step outside a mesh as it was. The frozen blocks take
``sp`` only as False: that step never splits the sequence.
"""
import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import model as Mod
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X


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


def attn_apply(p, spec, x, *, positions, memory=None, sp=False):
    assert not sp
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


def mlp_apply(p, spec, x, sp=False):
    assert not sp
    h = L.rmsnorm(x, p["norm"], spec.norm_eps)
    return x + mlp_core(p, spec, h)


def embed_apply(p, tokens, dtype, vocab=None, sp=False):
    assert not sp
    emb = p["embedding"]
    out = torch.index_select(emb, 0, tokens.reshape(-1))
    return out.reshape(*tokens.shape, emb.shape[-1]).to(dtype)


def unembed_apply(p, x, tie, vocab=None, sp=False):
    assert not sp
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


def _ssm_inputs(p, spec, x):
    N, R = spec.cfg.d_state, spec.dt_rank
    xdb = x @ p["x_proj"]
    dt_r, Bm, Cm = torch.split(xdb, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    dA = dt[..., None] * A
    bx = (dt * x.float())[..., None] * Bm.float()[:, :, None, :]
    return dA, bx, Cm.float()


def _mamba_forward(p, spec, x):
    B, S, _ = x.shape
    di, N = spec.d_inner, spec.cfg.d_state
    h0 = L.rmsnorm(x, p["norm"], spec.norm_eps)
    xin, z = torch.chunk(h0 @ p["in_proj"], 2, dim=-1)
    xc, conv_state = SSM._causal_conv(xin, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dA, bx, Cm = _ssm_inputs(p, spec, xc)
    nc = max(1, S // SSM.CHUNK)
    Q = S // nc
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        a_cum, b_cum = SSM._chunk_scan(torch.exp(dA[:, sl]), bx[:, sl])
        h_all = a_cum * h[:, None] + b_cum
        ys.append(torch.einsum("bqdn,bqn->bqd", h_all, Cm[:, sl]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)
    y = (y + p["D"].float() * xc.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return x + out, {"h": h, "conv": conv_state}


def mamba_decode(p, spec, x, cache):
    h0 = L.rmsnorm(x, p["norm"], spec.norm_eps)
    xin, z = torch.chunk(h0 @ p["in_proj"], 2, dim=-1)
    xc, conv_state = SSM._causal_conv(xin, p["conv_w"], p["conv_b"],
                                      cache["conv"])
    xc = F.silu(xc)
    dA, bx, Cm = _ssm_inputs(p, spec, xc)
    h_new = torch.exp(dA[:, 0]) * cache["h"] + bx[:, 0]
    y = torch.einsum("bdn,bn->bd", h_new, Cm[:, 0])[:, None]
    y = (y + p["D"].float() * xc.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return x + out, cache


def _mlstm_qkvgates(p, spec, x, conv_state=None):
    B, S, _ = x.shape
    H, hd = spec.n_heads, spec.head_dim
    h0 = L.rmsnorm(x, p["norm"], spec.norm_eps)
    xu, z = torch.chunk(h0 @ p["up_proj"], 2, dim=-1)
    xc, conv_state = SSM._causal_conv(xu, p["conv_w"], p["conv_b"],
                                      conv_state)
    xc = F.silu(xc)
    q = (xc @ p["wq"]).reshape(B, S, H, hd)
    k = ((xc @ p["wk"]) / math.sqrt(hd)).reshape(B, S, H, hd)
    v = (xu @ p["wv"]).reshape(B, S, H, hd)
    log_i = torch.clamp((xc @ p["w_i"] + p["b_i"]).float(),
                        -X.ICLIP, X.ICLIP)
    log_f = F.logsigmoid((xc @ p["w_f"] + p["b_f"]).float())
    o = torch.sigmoid(xu @ p["w_o"])
    return q, k, v, log_i, log_f, o, z, conv_state


def _mlstm_forward(p, spec, x):
    B, S, _ = x.shape
    H, hd = spec.n_heads, spec.head_dim
    q, k, v, log_i, log_f, o, z, conv_state = _mlstm_qkvgates(p, spec, x)
    nc = max(1, S // X.CHUNK)
    Q = S // nc
    qf, kf, vf = (t.float() for t in (q, k, v))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    hs = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        qc, kc, vc, li, lf = qf[:, sl], kf[:, sl], vf[:, sl], \
            log_i[:, sl], log_f[:, sl]
        Lc = torch.cumsum(lf, dim=1)
        Dlog = Lc[:, :, None, :] - Lc[:, None, :, :] + li[:, None, :, :]
        Dm = torch.where(tri[None, :, :, None], torch.exp(Dlog),
                         torch.zeros((), device=x.device))
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * Dm
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vc)
        n_intra = scores.sum(dim=2)
        eL = torch.exp(Lc)
        y_inter = torch.einsum("bthd,bhde->bthe", qc, C) * eL[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", qc, n) * eL
        Ltot = Lc[:, -1]
        w = torch.exp(Ltot[:, None] - Lc + li)
        C = (C * torch.exp(Ltot)[..., None, None]
             + torch.einsum("bshd,bshe,bsh->bhde", kc, vc, w))
        n = (n * torch.exp(Ltot)[..., None]
             + torch.einsum("bshd,bsh->bhd", kc, w))
        denom = torch.clamp_min((n_intra + n_inter).abs(), 1.0)
        hs.append((y_intra + y_inter) / denom[..., None])
    h = torch.cat(hs, dim=1).reshape(B, S, -1).to(x.dtype)
    out = ((h * o) * F.silu(z)) @ p["down_proj"]
    return x + out, {"C": C, "n": n, "conv": conv_state}


def mlstm_decode(p, spec, x, cache):
    B = x.shape[0]
    q, k, v, log_i, log_f, o, z, conv_state = _mlstm_qkvgates(
        p, spec, x, cache["conv"])
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    i_g = torch.exp(log_i[:, 0])[..., None]
    f_g = torch.exp(log_f[:, 0])[..., None]
    C_new = f_g[..., None] * cache["C"] + i_g[..., None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = f_g * cache["n"] + i_g * kf
    y = torch.einsum("bhd,bhde->bhe", qf, C_new)
    denom = torch.clamp_min(
        torch.einsum("bhd,bhd->bh", qf, n_new).abs(), 1.0)
    h = (y / denom[..., None]).reshape(B, 1, -1).to(x.dtype)
    out = ((h * o) * F.silu(z)) @ p["down_proj"]
    cache["C"].copy_(C_new)
    cache["n"].copy_(n_new)
    cache["conv"].copy_(conv_state)
    return x + out, cache


def _slstm_ffn(p, spec, x):
    hf = L.rmsnorm(x, p["norm"], spec.norm_eps)
    return x + F.gelu(hf @ p["wff_u"], approximate="tanh") @ p["wff_d"]


def _slstm_forward(p, spec, x):
    B, S, d = x.shape
    h0 = L.rmsnorm(x, p["norm"], spec.norm_eps)
    xw = (h0 @ p["wx"] + p["bias"]).float()
    r = p["r"].float()
    state = tuple(torch.zeros((B, d), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        state = X._slstm_cell(r, spec, xw[:, t], state)
        hs.append(state[2])
    c, n, hl, m = state
    x = x + torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_ffn(p, spec, x), {"c": c, "n": n, "h": hl, "m": m}


def slstm_decode(p, spec, x, cache):
    h0 = L.rmsnorm(x, p["norm"], spec.norm_eps)
    xw = (h0[:, 0] @ p["wx"] + p["bias"]).float()
    keys = ("c", "n", "h", "m")
    new = X._slstm_cell(p["r"].float(), spec, xw,
                        tuple(cache[k] for k in keys))
    x = x + new[2][:, None].to(x.dtype)
    for k, t in zip(keys, new):
        cache[k].copy_(t)
    return _slstm_ffn(p, spec, x), cache


_FROZEN = [(Mod, "cross_entropy", cross_entropy),
           (L, "attn_apply", attn_apply), (L, "mlp_apply", mlp_apply),
           (L, "embed_apply", embed_apply),
           (L, "unembed_apply", unembed_apply), (M, "moe_apply", moe_apply),
           (SSM, "_mamba_forward", _mamba_forward),
           (SSM, "mamba_decode", mamba_decode),
           (X, "_mlstm_forward", _mlstm_forward),
           (X, "mlstm_decode", mlstm_decode),
           (X, "_slstm_forward", _slstm_forward),
           (X, "slstm_decode", slstm_decode)]


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
