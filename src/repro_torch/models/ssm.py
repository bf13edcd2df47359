"""Mamba-1 selective SSM block (jamba's recurrent layer), and the Mamba-2
(SSD) mixer of granite-4.0-h (its own section below).

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


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): granite-4.0-h's mixer
# ---------------------------------------------------------------------------
#
# As ``GraniteMoeHybridMambaLayer`` computes it (transformers'
# ``modeling_granitemoehybrid.py``, its ``torch_forward``): ``in_proj``
# splits into [z | xBC | dt]; a depthwise causal conv of ``d_conv`` taps
# with bias over xBC, then SiLU; xBC splits into x [H heads of P], B and
# C [G groups of N]; dt = softplus(dt + dt_bias); A = -exp(A_log), one a
# head; h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = C_t · h_t +
# D x_t; then the gated norm (y · silu(z), RMSNorm over all d_inner
# channels, times its weight) and ``out_proj``. The conv, the scan and
# the gated norm run in f32; the state is f32. Prefill and training scan
# chunks of ``chunk`` steps in the SSD form (a masked decay matrix inside
# a chunk, the state carried between chunks); decode updates the state in
# place. The block is never split over a mesh: its leaves' inner dims are
# ``_nt`` (whole on every rank).


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    cfg: SSMConfig
    norm_eps: float
    res_mult: float = 1.0          # the output's factor before the residual

    @property
    def d_inner(self) -> int:
        return self.cfg.expand * self.d_model

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.cfg.n_groups * self.cfg.d_state

    def __post_init__(self):
        if self.cfg.n_heads * self.cfg.head_dim != self.d_inner:
            raise ValueError(
                f"Mamba-2: {self.cfg.n_heads} heads of {self.cfg.head_dim} "
                f"do not make d_inner {self.d_inner}")
        if self.cfg.n_heads % self.cfg.n_groups:
            raise ValueError(f"Mamba-2: {self.cfg.n_heads} heads over "
                             f"{self.cfg.n_groups} groups")


def mamba2_init(b: ParamBuilder, spec: Mamba2Spec) -> None:
    d, di, H = spec.d_model, spec.d_inner, spec.cfg.n_heads
    W, cd = spec.cfg.d_conv, spec.conv_dim
    b.add("norm", (d,), ("embed_nt",), init="ones")
    b.add("in_proj", (d, di + cd + H), ("embed", "ssm2_nt"))
    b.add("conv_w", (W, cd), (None, "ssm2_nt"), scale=1.0 / math.sqrt(W))
    b.add("conv_b", (cd,), ("ssm2_nt",), init="zeros")
    b.add("dt_bias", (H,), ("ssm2_nt",), init="zeros")
    b.add("A_log", (H,), ("ssm2_nt",), init="log_arange")
    b.add("D", (H,), ("ssm2_nt",), init="ones")
    b.add("gate_norm", (di,), ("ssm2_nt",), init="ones")
    b.add("out_proj", (di, d), ("ssm2_nt", "embed"),
          scale=1.0 / math.sqrt(di))


def _mamba2_in(p: Params, spec: Mamba2Spec, x: torch.Tensor,
               conv_state: Optional[torch.Tensor] = None):
    """The pre-norm, ``in_proj`` and the conv: (z, x [B,S,H,P] f32,
    B and C [B,S,G,N] f32, dt [B,S,H] f32, the conv's new state)."""
    c = spec.cfg
    di, cd, H, G, N = spec.d_inner, spec.conv_dim, c.n_heads, c.n_groups, \
        c.d_state
    h0 = rmsnorm(x, p["norm"], spec.norm_eps)
    z, xbc, dt = torch.split(h0 @ p["in_proj"], [di, cd, H], dim=-1)
    conv, new_state = _causal_conv(xbc.float(), p["conv_w"].float(),
                                   p["conv_b"].float(),
                                   None if conv_state is None
                                   else conv_state.float())
    xs, Bm, Cm = torch.split(F.silu(conv), [di, G * N, G * N], dim=-1)
    Bsz, S = x.shape[:2]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return (z, xs.reshape(Bsz, S, H, c.head_dim),
            Bm.reshape(Bsz, S, G, N), Cm.reshape(Bsz, S, G, N), dt,
            new_state.to(x.dtype))


def _mamba2_out(p: Params, spec: Mamba2Spec, x: torch.Tensor,
                y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor
                ) -> torch.Tensor:
    """y [B,S,H,P] f32 (C · h) -> the block's output, before its residual:
    D x added, the gated norm in f32, ``out_proj`` in the compute dtype."""
    Bsz, S = y.shape[:2]
    y = (y + p["D"].float()[:, None] * xs).reshape(Bsz, S, -1)
    g = y * F.silu(z.float())
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + spec.norm_eps)
    g = (g * p["gate_norm"].float()).to(x.dtype)
    return g @ p["out_proj"]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             h: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in f32. x [B,S,H,P], dt [B,S,H], A [H], Bm, Cm
    [B,S,G,N], ``h`` [B,H,P,N] the state before the first step (zeros by
    default) -> (y [B,S,H,P] = C_t · h_t, the state after the last step).

    Each chunk of ``chunk`` steps (the last may be shorter) in one pass:
    with a_t = dt_t A and its running sum s_t over the chunk, the chunk's
    own steps reach step i through exp(s_i - s_j) (j <= i), the state
    carried in through exp(s_i), and the state handed on is exp(s_last)
    h + Σ_j exp(s_last - s_j) dt_j x_j ⊗ B_j."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    E = H // G
    if h is None:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                        device=x.device)
    h = h.reshape(Bsz, G, E, P, N)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        Q = sl.stop - sl.start
        a = (dt[:, sl] * A).reshape(Bsz, Q, G, E)
        s = torch.cumsum(a, dim=1)                          # [B,Q,G,E]
        xdt = (x[:, sl] * dt[:, sl, :, None]).reshape(Bsz, Q, G, E, P)
        Bc, Cc = Bm[:, sl], Cm[:, sl]                        # [B,Q,G,N]
        live = torch.ones((Q, Q), dtype=torch.bool,
                          device=x.device).tril()
        sp = s.permute(0, 2, 3, 1)                           # [B,G,E,Q]
        seg = sp[..., :, None] - sp[..., None, :]            # [B,G,E,Qi,Qj]
        decay = torch.exp(torch.where(live, seg, -math.inf))
        cb = torch.einsum("bign,bjgn->bgij", Cc, Bc)         # [B,G,Q,Q]
        y = torch.einsum("bgeij,bjgep->bigep", decay * cb[:, :, None], xdt)
        y = y + torch.exp(s)[..., None] * torch.einsum(
            "bign,bgepn->bigep", Cc, h)
        ys.append(y.reshape(Bsz, Q, H, P))
        last = s[:, -1]                                      # [B,G,E]
        w = torch.exp(last[:, None] - s)[..., None] * xdt    # [B,Q,G,E,P]
        h = (torch.exp(last)[..., None, None] * h
             + torch.einsum("bjgep,bjgn->bgepn", w, Bc))
    return torch.cat(ys, dim=1), h.reshape(Bsz, H, P, N)


def _mamba2_forward(p: Params, spec: Mamba2Spec, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train/prefill forward: (the block's output before its residual,
    cache {h, conv})."""
    z, xs, Bm, Cm, dt, conv_state = _mamba2_in(p, spec, x)
    A = -torch.exp(p["A_log"].float())
    y, h = ssd_scan(xs, dt, A, Bm, Cm, spec.cfg.chunk)
    return _mamba2_out(p, spec, x, y, xs, z), {"h": h, "conv": conv_state}


def _residual(spec: Mamba2Spec, x: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    return x + (out if spec.res_mult == 1.0 else out * spec.res_mult)


def mamba2_apply(p: Params, spec: Mamba2Spec, x: torch.Tensor
                 ) -> torch.Tensor:
    """Training forward. x: [B,S,d] -> [B,S,d] (with residual)."""
    return _residual(spec, x, _mamba2_forward(p, spec, x)[0])


def mamba2_prefill(p: Params, spec: Mamba2Spec, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out, cache = _mamba2_forward(p, spec, x)
    return _residual(spec, x, out), cache


def mamba2_cache_init(spec: Mamba2Spec, batch: int, dtype,
                      device: Any) -> Dict[str, torch.Tensor]:
    c = spec.cfg
    return {
        "h": torch.zeros((batch, c.n_heads, c.head_dim, c.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, c.d_conv - 1, spec.conv_dim),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p: Params, spec: Mamba2Spec, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B,1,d]. Updates ``h`` [B,H,P,N] in place in
    two passes over it (the decay, then the rank-1 update as one batched
    GEMM into it) and reads it once more for y; writes the new ``conv``
    window in place; returns the same cache tensors."""
    z, xs, Bm, Cm, dt, conv_state = _mamba2_in(p, spec, x, cache["conv"])
    c = spec.cfg
    Bsz, H, P, N = cache["h"].shape
    E = H // c.n_groups
    A = -torch.exp(p["A_log"].float())
    h = cache["h"].view(Bsz * H, P, N)
    h.mul_(torch.exp(dt[:, 0] * A).reshape(Bsz * H, 1, 1))
    xdt = (xs[:, 0] * dt[:, 0, :, None]).reshape(Bsz * H, P, 1)
    Bh = Bm[:, 0].repeat_interleave(E, dim=1).reshape(Bsz * H, 1, N)
    Ch = Cm[:, 0].repeat_interleave(E, dim=1).reshape(Bsz * H, N, 1)
    h.baddbmm_(xdt, Bh)
    y = torch.bmm(h, Ch).reshape(Bsz, 1, H, P)
    out = _mamba2_out(p, spec, x, y, xs, z)
    cache["conv"].copy_(conv_state)
    return _residual(spec, x, out), cache
