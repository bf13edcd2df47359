"""Mixture-of-Experts layer with capacity-based, gather/scatter dispatch.

Port of ``repro/models/moe.py`` (plain code there too: no Pallas kernel).
Tokens are grouped per batch example; expert capacity is per example,
``C = ceil(S * top_k * capacity_factor / E)`` (at least 4, a multiple of
4), and tokens past it are dropped (Switch/GShard semantics). Slots are
assigned from an exclusive cumulative count in s-major, k-minor order;
every expert runs its FFN over all ``C`` slots, empty ones zero.

Where the reference scatters every dropped token into one extra slot
(``mode="drop"``), the port sends each dropped (token, choice) pair to a
slot of its own past the ``E * C`` real ones, so no index of the scatter
repeats: its result does not depend on the order of writes, on the CPU
or under the card's deterministic mode. Token features move to the
slots and back by row lookups (``_rows``), not by ``torch.gather`` over an
index expanded to every feature: a gather's backward is a
``scatter_add``, which the card's deterministic mode sorts with one index
per element (16 GB at llama4-scout's train_4k rank shape), where a row
lookup's backward sorts one index a row. The top-k is a stable
descending sort, so ties (frequent in bf16 logits) go to the lower
expert index, as ``lax.top_k`` gives them.

Under ``sharding.specs.activation_sharding(axes, mesh)``, as the
reference's constraints at its dispatch and return: each rank of the
``ep`` axis holds E/ep experts (``we_*`` split over ``experts``) and runs
them over its slots of the dispatched tokens; their outputs are gathered
back over ``ep`` (one all-gather), and the routing and the combine run
the same on every rank. The llama4 shared expert is split over ``ff``
like the MLP. The Switch aux is taken over the whole batch: the
per-expert first-choice counts (whose total is the token count) and the
per-expert probability sums are summed over the data-parallel ranks
before their product is formed, the probability sums through
``specs.dp_sum`` (identity backward), so the gradient flows through
them.

Under the stack's selective remat (``remat="save_moe"``,
``transformer.stack_forward``) the layer hands its two boundary tensors,
the reference's ``moe_dispatch`` (the dispatched rows ``x_e``) and
``moe_expert_out`` (the expert output, gathered back over ``ep``), to a
``Kept``: the group's forward holds them, and its recompute in the
backward reads them back, so that it does not run the gather again.

Dropless dispatch (``capacity_factor=None``: granite-4.0-h's MoE, whose
published layer drops no pair). Every (token, choice) pair is computed:
the pairs are sorted by expert on the device (a stable sort, so each
expert's rows keep token order), each expert's FFN runs over its run of
rows as one grouped GEMM (``torch._grouped_mm`` with the runs' ends as
device offsets; on the CPU or in f32, one matmul an expert), and the
outputs go back to pair order by the inverse permutation. No shape
depends on the routing and nothing is read back to the host, so a decode
step that holds it replays from one CUDA graph; the rows computed are the
pairs routed, where the capacity dispatch computes ``E * C`` a row of the
batch. Each call adds the pairs it routed and the expert rows it
computed to the registry counters ``moe.routed_pairs`` and
``moe.expert_rows`` (``COUNTERS``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import MLPSpec, ParamBuilder, mlp_core, rmsnorm
from repro_torch.obs.telemetry import registry
from repro_torch.sharding import specs as SH

# the registry counters of every dispatch: pairs routed, expert rows run
COUNTERS = ("moe.routed_pairs", "moe.expert_rows")

Params = Any


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    cfg: MoEConfig
    act: str
    norm_eps: float
    d_ff_shared: int = 0           # >0: llama4-style shared expert
    res_mult: float = 1.0          # the output's factor before the residual


def moe_capacity(seq: int, cfg: MoEConfig) -> int:
    c = math.ceil(seq * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, ((c + 3) // 4) * 4)


def moe_init(b: ParamBuilder, spec: MoESpec) -> None:
    d, m = spec.d_model, spec.cfg
    b.add("norm", (d,), ("embed_nt",), init="ones")
    b.add("router", (d, m.num_experts), ("embed_nt", "experts_nt"),
          scale=0.02)
    mult_gate = spec.act == "swiglu"
    if mult_gate:
        b.add("we_g", (m.num_experts, d, m.d_ff), ("experts", "moe_embed", "moe_ff"))
    b.add("we_u", (m.num_experts, d, m.d_ff), ("experts", "moe_embed", "moe_ff"))
    b.add("we_d", (m.num_experts, m.d_ff, d), ("experts", "moe_ff", "moe_embed"),
          scale=1.0 / math.sqrt(m.d_ff))
    if spec.d_ff_shared > 0:
        if mult_gate:
            b.add("ws_g", (d, spec.d_ff_shared), ("embed", "ff"))
        b.add("ws_u", (d, spec.d_ff_shared), ("embed", "ff"))
        b.add("ws_d", (spec.d_ff_shared, d), ("ff", "embed"),
              scale=1.0 / math.sqrt(spec.d_ff_shared))


def _expert_ffn(p: Params, act: str, x_e: torch.Tensor) -> torch.Tensor:
    """x_e: [B, E, C, d] -> [B, E, C, d], per-expert weights [E, d, f]."""
    if act == "swiglu":
        g = torch.einsum("becd,edf->becf", x_e, p["we_g"])
        u = torch.einsum("becd,edf->becf", x_e, p["we_u"])
        h = F.silu(g) * u
    elif act == "squared_relu":
        h = torch.square(F.relu(torch.einsum("becd,edf->becf", x_e,
                                             p["we_u"])))
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", x_e, p["we_u"]),
                   approximate="tanh")
    return torch.einsum("becf,efd->becd", h, p["we_d"])


def _grouped_mm(x: torch.Tensor, w: torch.Tensor,
                ends: torch.Tensor) -> torch.Tensor:
    """x [n, k] whose rows ``ends[e-1]:ends[e]`` belong to expert e, w
    [E, k, m] -> [n, m], each run of rows times its expert's matrix."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=ends.to(torch.int32))
    out = x.new_empty((x.shape[0], w.shape[-1]))
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[e]
        lo = hi
    return out


def _dropless(p: Params, act: str, h: torch.Tensor, gates: torch.Tensor,
              expert_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Every (token, choice) pair through its expert: h [B,S,d], gates and
    expert_idx [B,S,K] -> the gate-weighted sum [B,S,d], in the compute
    dtype."""
    B, S, d = h.shape
    K = expert_idx.shape[-1]
    flat = expert_idx.reshape(-1)                      # token-major pairs
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], torch.arange(
        1, E + 1, device=h.device, dtype=flat.dtype))
    x_s = h.reshape(B * S, d)[torch.div(order, K, rounding_mode="floor")]
    if act == "swiglu":
        u = F.silu(_grouped_mm(x_s, p["we_g"], ends)) \
            * _grouped_mm(x_s, p["we_u"], ends)
    elif act == "squared_relu":
        u = torch.square(F.relu(_grouped_mm(x_s, p["we_u"], ends)))
    else:
        u = F.gelu(_grouped_mm(x_s, p["we_u"], ends), approximate="tanh")
    y_s = _grouped_mm(u, p["we_d"], ends)
    y = torch.empty_like(y_s).index_copy_(0, order, y_s).reshape(B * S, K, d)
    registry().inc(COUNTERS[0], flat.numel())
    registry().inc(COUNTERS[1], x_s.shape[0])
    return (y * gates.reshape(B * S, K, 1).to(h.dtype)).sum(1).reshape(
        B, S, d)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [B, N, d], idx: [B, M] -> [B, M, d], x[b, idx[b, m]]: the values
    of ``torch.gather(x, 1, idx[..., None].expand(B, M, d))``. Its
    backward accumulates one row at a time (``index_put_``), in index
    order, deterministic on the card."""
    B, N, d = x.shape
    flat = idx + N * torch.arange(B, device=idx.device)[:, None]
    return x.reshape(B * N, d)[flat.reshape(-1)].reshape(B, -1, d)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: descending, ties to the lower
    index (a stable sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Kept:
    """The tensors that a group remat'd under ``remat="save_moe"`` keeps
    for its backward, in the order its MoE layers hand them over: the
    group's first run (its forward) holds each, and each later run (its
    recompute in the backward, ``torch.utils.checkpoint``) reads them
    back in their place, with the gradient of what it formed again (no
    collective: ``specs.formed``). The values are the ones the forward
    formed, so the gradients are full remat's."""

    def __init__(self):
        self.held: List[torch.Tensor] = []
        self.runs, self.i = 0, 0

    def start(self) -> None:
        """A run of the group begins."""
        self.runs, self.i = self.runs + 1, 0

    def __call__(self, t: torch.Tensor, dim: int = 0,
                 kind: Optional[str] = None) -> torch.Tensor:
        """``t``, or where ``kind`` is given the ranks' slices of ``t``
        joined along ``dim`` over its axis (``specs.gather_from_tp``),
        held in the forward and read back in the recompute."""
        if self.runs == 1:
            out = t if kind is None else SH.gather_from_tp(t, dim, kind)
            self.held.append(out.detach())
            return out
        self.i += 1
        return SH.formed(t, self.held[self.i - 1], dim, kind)


def moe_apply(p: Params, spec: MoESpec, x: torch.Tensor,
              kept: Optional[Kept] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (x + moe(x), aux_loss). ``kept`` holds the
    dispatched rows and the gathered expert output for the backward
    (``remat="save_moe"``)."""
    m = spec.cfg
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    dt, dev = x.dtype, x.device

    h = rmsnorm(x, p["norm"], spec.norm_eps)

    # --- routing: matmul in compute dtype, softmax in f32 ------------------
    logits = (h @ p["router"].to(dt)).float()                 # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = top_k(probs, K)                       # [B,S,K]
    if K > 1:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    if m.capacity_factor is None:
        if SH.ep_group() is not None or SH.tp_size() > 1:
            raise NotImplementedError("the dropless MoE runs on one rank")
        y = _dropless(p, spec.act, h, gates, expert_idx, E)
        return _finish(p, spec, x, h, y, probs, expert_idx)

    # --- slot assignment (order: s-major, k-minor) -------------------------
    C = moe_capacity(S, m)
    flat_idx = expert_idx.reshape(B, S * K)                   # [B, SK]
    onehot = F.one_hot(flat_idx, E)                           # [B, SK, E]
    pos = torch.cumsum(onehot, dim=1) - onehot                # count before me
    pos = torch.gather(pos, 2, flat_idx[..., None])[..., 0]   # [B, SK]
    keep = pos < C
    slot = torch.where(keep, flat_idx * C + pos, E * C)       # E*C = dropped

    # --- dispatch: scatter token index, gather token features -------------
    # a dropped pair j writes slot E*C + j: every index of a row is unique
    order = torch.arange(S * K, device=dev)
    dest = torch.where(keep, slot, E * C + order)
    token_src = torch.zeros((B, E * C + S * K), dtype=torch.long,
                            device=dev).scatter(
        1, dest, (order + 1).expand(B, S * K))[:, :E * C]    # [B, EC]; 0=empty
    # the dp -> ep boundary: this rank's experts' slots only
    split = SH.ep_group() is not None and SH.constrain(
        (B, E, C, d), (None, "ep", None, None))[1] is not None
    h_e, e0, El = h, 0, E
    if split:
        El = E // SH.active_axis_size("ep")
        e0 = SH.ep_rank() * El
        token_src = token_src[:, e0 * C:(e0 + El) * C]
        h_e = SH.copy_to_tp(h, kind="ep")
    src_s = torch.clamp(torch.div(token_src - 1, K, rounding_mode="floor"),
                        0, S - 1)
    x_e = _rows(h_e, src_s)                                  # [B, El*C, d]
    x_e = x_e * (token_src > 0)[..., None].to(dt)
    x_e = x_e.reshape(B, El, C, d)
    if kept is not None:                    # the reference's moe_dispatch
        x_e = kept(x_e)

    # --- expert compute ----------------------------------------------------
    y_e = _expert_ffn(p, spec.act, x_e)
    if kept is not None:                    # and its moe_expert_out
        y_e = kept(y_e, 1, "ep" if split else None)
    elif split:                             # back to every expert's slots
        y_e = SH.gather_from_tp(y_e, 1, kind="ep")
    y_e = y_e.reshape(B, E * C, d)

    # --- combine: gather back to token order, in the compute dtype ---------
    slot_c = torch.clamp(slot, 0, E * C - 1)
    y_tok = _rows(y_e, slot_c)                               # [B, S*K, d]
    scale = (keep.float() * gates.reshape(B, S * K)).to(dt)[..., None]
    y_tok = y_tok * scale
    if K == 1:
        y = y_tok.reshape(B, S, d)
    else:
        y = y_tok.reshape(B, S, K, d).sum(dim=2)
    registry().inc(COUNTERS[0], B * S * K)
    registry().inc(COUNTERS[1], B * El * C)
    return _finish(p, spec, x, h, y, probs, expert_idx)


def _finish(p: Params, spec: MoESpec, x: torch.Tensor, h: torch.Tensor,
            y: torch.Tensor, probs: torch.Tensor, expert_idx: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shared expert added to the routed output, the residual, and the
    load-balancing aux."""
    E = spec.cfg.num_experts
    # --- shared expert ------------------------------------------------------
    if spec.d_ff_shared > 0:
        shared = {"wg": p.get("ws_g"), "wu": p["ws_u"], "wd": p["ws_d"]}
        y = y + mlp_core(shared, MLPSpec(spec.d_model, spec.d_ff_shared,
                                         spec.act, spec.norm_eps), h)

    # --- load-balancing aux loss (Switch-style), over the whole batch ------
    first = F.one_hot(expert_idx[..., 0], E).float()
    # a serving batch replicated on the data ranks (a kvseq split) is
    # whole on each: nothing to sum over them
    if SH.dp_size() == 1 or SH.kvseq_active():
        frac_tokens = first.mean(dim=(0, 1))
        mean_probs = probs.mean(dim=(0, 1))
    else:
        counts = SH.dp_all_reduce(first.sum(dim=(0, 1)))
        n_tok = counts.sum()             # one first choice a token
        frac_tokens = counts / n_tok
        mean_probs = SH.dp_sum(probs.sum(dim=(0, 1))) / n_tok
    aux = (frac_tokens * mean_probs).sum() * E

    if spec.res_mult != 1.0:
        y = y * spec.res_mult
    return x + y, aux
