"""Decoder and encoder stacks built from block templates (``attn``,
``cross_attn``, ``mlp``, ``moe``, ``mamba``, ``mlstm`` and ``slstm``).

Port of ``repro/models/transformer.py``. An architecture is compiled into
a *group program*: the list of ``Block`` templates covering one period of
its layer pattern (e.g. jamba: ``[attn+mlp, mamba+moe, mamba+mlp, ...]``,
8 layers; xlstm: ``[mlstm, slstm]``; an enc-dec decoder layer:
``[attn, cross_attn, mlp]``). The stack keeps the reference's stacked
layout — every leaf has a leading ``[n_groups]`` dim, as ``init_stack``'s
``vmap`` makes it — so images and converted inits carry over one to one.
The reference's ``lax.scan`` over groups becomes a Python loop over the
unbound stacked tensors, and its ``jax.checkpoint`` remat becomes
``torch.utils.checkpoint`` (neither changes a number). Decode caches keep
the reference's stacked layout (``[n_groups, B, T, Hkv, hd]`` for k/v and
for the cross-attention memory ``mk``/``mv`` over ``T_enc`` slots; the
f32 recurrent states of Mamba and xLSTM beside their conv windows) and
block names, so a serving image crosses between the packages; decode
updates them in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X
from repro_torch.tree import map_dicts

Params = Any


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str            # attn | cross_attn | mlp | moe | mamba | mlstm | slstm
    name: str
    spec: Any


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_group(cfg: ArchConfig) -> Tuple[List[Block], int]:
    """One period of the layer pattern + how many times it repeats."""
    if cfg.xlstm is not None:
        gs = cfg.xlstm.slstm_every
        assert cfg.n_layers % gs == 0
        blocks: List[Block] = []
        for j in range(gs):
            if j == gs - 1:
                blocks.append(Block("slstm", f"l{j}_slstm", X.SLSTMSpec(
                    cfg.d_model, cfg.n_heads, cfg.norm_eps)))
            else:
                blocks.append(Block("mlstm", f"l{j}_mlstm", X.MLSTMSpec(
                    cfg.d_model, cfg.n_heads, cfg.xlstm, cfg.norm_eps)))
        return blocks, cfg.n_layers // gs

    gs = 1
    if cfg.attn_pattern == "local_global":
        gs = _lcm(gs, cfg.local_global_ratio + 1)
    if cfg.attn_every > 1:
        gs = _lcm(gs, cfg.attn_every)
    if cfg.moe is not None:
        gs = _lcm(gs, cfg.moe.every)
    assert cfg.n_layers % gs == 0, (cfg.name, cfg.n_layers, gs)

    blocks = []
    for j in range(gs):
        # --- token mixer ------------------------------------------------
        if cfg.attn_every > 1 and (j % cfg.attn_every) != 0:
            blocks.append(Block("mamba", f"l{j}_mamba", SSM.MambaSpec(
                cfg.d_model, cfg.ssm, cfg.norm_eps)))
        else:
            window = None
            if cfg.attn_pattern == "local_global":
                r = cfg.local_global_ratio
                if (j % (r + 1)) != r:        # last of each sub-period = global
                    window = cfg.local_window
            blocks.append(Block("attn", f"l{j}_attn", L.AttnSpec(
                cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.rope_theta, cfg.norm_eps, window=window)))
            if cfg.encoder is not None:
                blocks.append(Block("cross_attn", f"l{j}_xattn", L.AttnSpec(
                    cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    cfg.rope_theta, cfg.norm_eps, cross=True,
                    use_rope=False)))
        # --- channel mixer ------------------------------------------------
        if cfg.moe is not None and (j % cfg.moe.every) == cfg.moe.every - 1:
            blocks.append(Block("moe", f"l{j}_moe", M.MoESpec(
                cfg.d_model, cfg.moe, cfg.mlp_act, cfg.norm_eps,
                d_ff_shared=cfg.d_ff if cfg.moe.shared_expert else 0)))
        elif cfg.d_ff > 0:
            blocks.append(Block("mlp", f"l{j}_mlp", L.MLPSpec(
                cfg.d_model, cfg.d_ff, cfg.mlp_act, cfg.norm_eps)))
    return blocks, cfg.n_layers // gs


def build_encoder_group(cfg: ArchConfig) -> Tuple[List[Block], int]:
    """The enc-dec encoder's layer (non-causal attention + MLP) and its
    depth."""
    e = cfg.encoder
    blocks = [
        Block("attn", "enc_attn", L.AttnSpec(
            cfg.d_model, e.n_heads, e.n_kv_heads, cfg.head_dim,
            cfg.rope_theta, cfg.norm_eps, causal=False)),
        Block("mlp", "enc_mlp", L.MLPSpec(cfg.d_model, e.d_ff, cfg.mlp_act,
                                          cfg.norm_eps)),
    ]
    return blocks, e.n_layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(b: L.ParamBuilder, blk: Block) -> None:
    if blk.kind in ("attn", "cross_attn"):
        L.attn_init(b, blk.spec)
    elif blk.kind == "mlp":
        L.mlp_init(b, blk.spec)
    elif blk.kind == "moe":
        M.moe_init(b, blk.spec)
    elif blk.kind == "mamba":
        SSM.mamba_init(b, blk.spec)
    elif blk.kind == "mlstm":
        X.mlstm_init(b, blk.spec)
    elif blk.kind == "slstm":
        X.slstm_init(b, blk.spec)
    else:
        raise ValueError(blk.kind)


def _stack_trees(trees: List[Any]) -> Any:
    """Stack per-group dicts leaf by leaf, keys in sorted order (the order
    the reference's ``vmap`` output has). Each leaf is popped from the
    group dicts as it is stacked, so the groups and the stack together
    hold one copy of the params and one stacked leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t.pop(k) for t in trees])
                for k in sorted(trees[0])}
    return torch.stack(trees)


def init_stack(gen: torch.Generator, blocks: List[Block], n_groups: int,
               dtype, device: Any) -> Params:
    """Stacked params: every leaf gets a leading [n_groups] dim."""
    def one_group():
        b = L.ParamBuilder(gen, dtype, device)
        for blk in blocks:
            b.sub(blk.name, lambda bb, blk=blk: _init_block(bb, blk))
        return b.params

    return _stack_trees([one_group() for _ in range(n_groups)])


def stack_dims(blocks: List[Block]) -> Any:
    """Logical-dims tree matching ``init_stack`` (built on the ``meta``
    device: nothing is drawn or allocated, so full-size configs are safe)."""
    db: Dict[str, Any] = {}
    for blk in blocks:
        b = L.ParamBuilder(None, torch.float32, torch.device("meta"))
        _init_block(b, blk)
        db[blk.name] = b.dims
    return map_dicts(lambda d: ("layers",) + tuple(d), db)


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------

def _groups(params_stack: Params) -> List[Params]:
    """The per-group views of a stacked tree. Each leaf is unbound once:
    the backward of ``unbind`` stacks the per-group grads in one op."""
    unbound = map_dicts(lambda t: t.unbind(0), params_stack)
    n = len(next(iter(next(iter(unbound.values())).values())))
    return [map_dicts(lambda ts, i=i: ts[i], unbound) for i in range(n)]


def _group_body(blocks: List[Block], x: torch.Tensor, positions: torch.Tensor,
                p_g: Dict[str, Dict[str, torch.Tensor]], aux: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    for blk in blocks:
        p = p_g[blk.name]
        if blk.kind == "attn":
            x = L.attn_apply(p, blk.spec, x, positions=positions)
        elif blk.kind == "cross_attn":
            mem = L.cross_attn_memory(p, blk.spec, enc_out)
            x = L.attn_apply(p, blk.spec, x, positions=positions, memory=mem)
        elif blk.kind == "mlp":
            x = L.mlp_apply(p, blk.spec, x)
        elif blk.kind == "moe":
            x, a = M.moe_apply(p, blk.spec, x)
            aux = aux + a
        elif blk.kind == "mamba":
            x = SSM.mamba_apply(p, blk.spec, x)
        elif blk.kind == "mlstm":
            x = X.mlstm_apply(p, blk.spec, x)
        elif blk.kind == "slstm":
            x = X.slstm_apply(p, blk.spec, x)
    return x, aux


def stack_forward(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                  positions: torch.Tensor, *,
                  enc_out: Optional[torch.Tensor] = None, remat: bool = True,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop the group program over the stacked params. Returns (x, aux),
    aux being the MoE aux loss summed over layers and groups (0 for
    stacks without MoE). ``enc_out`` is the encoder's output, which the
    cross-attention blocks attend to."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_g in _groups(params_stack):
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_group_body, blocks, x, positions, p_g, aux,
                                enc_out, use_reentrant=False)
        else:
            x, aux = _group_body(blocks, x, positions, p_g, aux, enc_out)
    return x, aux


def stack_encode(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                 positions: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """The encoder stack in serving (no autograd): its non-causal
    self-attention through the flash kernel, as a prefill without a
    cache."""
    for p_g in _groups(params_stack):
        for blk in blocks:
            p = p_g[blk.name]
            if blk.kind == "attn":
                x, _ = L.attn_prefill(p, blk.spec, x, positions=positions,
                                      impl=impl)
            elif blk.kind == "mlp":
                x = L.mlp_apply(p, blk.spec, x)
            else:
                raise ValueError(f"encoder block {blk.kind}")
    return x


# ---------------------------------------------------------------------------
# Prefill (returns decode caches) and decode
# ---------------------------------------------------------------------------

def stack_prefill(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                  positions: torch.Tensor, *,
                  enc_out: Optional[torch.Tensor] = None,
                  cache_len: Optional[int] = None,
                  impl: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """Forward + per-layer cache construction. ``cache_len`` pads the KV
    caches with zeros to that many slots; cross-attention layers keep the
    encoder memory ``mk``/``mv``; Mamba and xLSTM layers keep their final
    states."""
    B, S = x.shape[:2]
    groups = _groups(params_stack)
    cache = init_cache(blocks, len(groups), B, max(S, cache_len or 0),
                       x.dtype, x.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    for i, p_g in enumerate(groups):
        for blk in blocks:
            p = p_g[blk.name]
            c = None
            if blk.kind == "attn":
                x, kv = L.attn_prefill(p, blk.spec, x, positions=positions,
                                       impl=impl)
                for kk in ("k", "v"):
                    cache[blk.name][kk][i, :, :S] = kv[kk]
            elif blk.kind == "cross_attn":
                mk, mv = L.cross_attn_memory(p, blk.spec, enc_out)
                x = L.cross_attn_prefill(p, blk.spec, x, (mk, mv), impl=impl)
                c = {"mk": mk, "mv": mv}
            elif blk.kind == "mamba":
                x, c = SSM.mamba_prefill(p, blk.spec, x)
            elif blk.kind == "mlstm":
                x, c = X.mlstm_prefill(p, blk.spec, x)
            elif blk.kind == "slstm":
                x, c = X.slstm_prefill(p, blk.spec, x)
            elif blk.kind == "mlp":
                x = L.mlp_apply(p, blk.spec, x)
            elif blk.kind == "moe":
                x, _ = M.moe_apply(p, blk.spec, x)
            if c is not None:
                for kk, t in c.items():
                    cache[blk.name][kk][i] = t
    return x, cache


def stack_decode(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                 cache_stack: Params, pos: int, *,
                 impl: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """One-token decode through the stack. x: [B,1,d]. Writes slot ``pos``
    of every attention layer's cache and every Mamba and xLSTM layer's
    state in place (the cross-attention memory is only read); returns the
    same cache."""
    for i, p_g in enumerate(_groups(params_stack)):
        for blk in blocks:
            p = p_g[blk.name]
            if blk.name in cache_stack:
                c = {kk: t[i] for kk, t in cache_stack[blk.name].items()}
            if blk.kind == "attn":
                x, _ = L.attn_decode(p, blk.spec, x, c, pos, impl=impl)
            elif blk.kind == "cross_attn":
                x = L.cross_attn_decode(p, blk.spec, x, (c["mk"], c["mv"]),
                                        impl=impl)
            elif blk.kind == "mamba":
                x, _ = SSM.mamba_decode(p, blk.spec, x, c)
            elif blk.kind == "mlstm":
                x, _ = X.mlstm_decode(p, blk.spec, x, c)
            elif blk.kind == "slstm":
                x, _ = X.slstm_decode(p, blk.spec, x, c)
            elif blk.kind == "mlp":
                x = L.mlp_apply(p, blk.spec, x)
            elif blk.kind == "moe":
                x, _ = M.moe_apply(p, blk.spec, x)
    return x, cache_stack


# ---------------------------------------------------------------------------
# Cache construction + logical dims (for sharding)
# ---------------------------------------------------------------------------

def init_cache(blocks: List[Block], n_groups: int, batch: int,
               cache_len: int, dtype, device: Any,
               enc_len: int = 0) -> Params:
    """Zero-initialized decode cache (capacity ``cache_len``; the
    cross-attention memory holds ``enc_len`` slots)."""
    out: Dict[str, Any] = {}
    for blk in blocks:
        if blk.kind in ("attn", "cross_attn"):
            sp = blk.spec
            n = enc_len if blk.kind == "cross_attn" else cache_len
            shape = (n_groups, batch, n, sp.n_kv_heads, sp.head_dim)
            out[blk.name] = {kk: torch.zeros(shape, dtype=dtype,
                                             device=device)
                             for kk in (("mk", "mv") if sp.cross
                                        else ("k", "v"))}
            continue
        if blk.kind == "mamba":
            c = SSM.mamba_cache_init(blk.spec, batch, dtype, device)
        elif blk.kind == "mlstm":
            c = X.mlstm_cache_init(blk.spec, batch, dtype, device)
        elif blk.kind == "slstm":
            c = X.slstm_cache_init(blk.spec, batch, dtype, device)
        else:
            continue
        out[blk.name] = {kk: t[None].repeat(n_groups, *(1,) * t.dim())
                         for kk, t in c.items()}
    return out


def cache_dims(blocks: List[Block]) -> Any:
    """Logical dims tree matching ``init_cache`` output."""
    out: Dict[str, Any] = {}
    for blk in blocks:
        if blk.kind == "attn":
            d = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
            out[blk.name] = {"k": d, "v": d}
        elif blk.kind == "cross_attn":
            d = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
            out[blk.name] = {"mk": d, "mv": d}
        elif blk.kind == "mamba":
            out[blk.name] = {"h": ("layers", "batch", "ssm_inner", None),
                             "conv": ("layers", "batch", None, "ssm_inner")}
        elif blk.kind == "mlstm":
            out[blk.name] = {"C": ("layers", "batch", None, "head_dim", None),
                             "n": ("layers", "batch", None, "head_dim"),
                             "conv": ("layers", "batch", None, "xl_inner")}
        elif blk.kind == "slstm":
            d = ("layers", "batch", "embed_nt")
            out[blk.name] = {k: d for k in ("c", "n", "h", "m")}
    return out
