"""Decoder stacks built from block templates (``attn``, ``mlp``, ``moe``
and ``mamba``).

Port of ``repro/models/transformer.py`` for the decoder-only stacks. An
architecture is compiled into a *group program*: the list of ``Block``
templates covering one period of its layer pattern (e.g. jamba:
``[attn+mlp, mamba+moe, mamba+mlp, ...]``, 8 layers). The stack keeps the
reference's stacked layout — every leaf has a leading ``[n_groups]`` dim,
as ``init_stack``'s ``vmap`` makes it — so images and converted inits
carry over one to one. The reference's ``lax.scan`` over groups becomes a
Python loop over the unbound stacked tensors, and its ``jax.checkpoint``
remat becomes ``torch.utils.checkpoint`` (neither changes a number).
Decode caches keep the reference's stacked layout (``[n_groups, B, T,
Hkv, hd]`` for k/v, ``[n_groups, B, di, N]`` f32 ``h`` and ``[n_groups,
B, W-1, di]`` ``conv`` for Mamba) and block names, so a serving image
crosses between the packages; decode updates them in place.
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
from repro_torch.tree import map_dicts

Params = Any


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str            # attn | mlp | moe | mamba
    name: str
    spec: Any


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_group(cfg: ArchConfig) -> Tuple[List[Block], int]:
    """One period of the layer pattern + how many times it repeats."""
    missing = [what for what, part in (
        ("xlstm blocks", cfg.xlstm), ("the encoder stack", cfg.encoder),
        ("the vision frontend", cfg.frontend)) if part is not None]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet")
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
        # --- channel mixer ------------------------------------------------
        if cfg.moe is not None and (j % cfg.moe.every) == cfg.moe.every - 1:
            blocks.append(Block("moe", f"l{j}_moe", M.MoESpec(
                cfg.d_model, cfg.moe, cfg.mlp_act, cfg.norm_eps,
                d_ff_shared=cfg.d_ff if cfg.moe.shared_expert else 0)))
        elif cfg.d_ff > 0:
            blocks.append(Block("mlp", f"l{j}_mlp", L.MLPSpec(
                cfg.d_model, cfg.d_ff, cfg.mlp_act, cfg.norm_eps)))
    return blocks, cfg.n_layers // gs


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(b: L.ParamBuilder, blk: Block) -> None:
    if blk.kind == "attn":
        L.attn_init(b, blk.spec)
    elif blk.kind == "mlp":
        L.mlp_init(b, blk.spec)
    elif blk.kind == "moe":
        M.moe_init(b, blk.spec)
    elif blk.kind == "mamba":
        SSM.mamba_init(b, blk.spec)
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
                p_g: Dict[str, Dict[str, torch.Tensor]], aux: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    for blk in blocks:
        p = p_g[blk.name]
        if blk.kind == "attn":
            x = L.attn_apply(p, blk.spec, x, positions=positions)
        elif blk.kind == "mlp":
            x = L.mlp_apply(p, blk.spec, x)
        elif blk.kind == "moe":
            x, a = M.moe_apply(p, blk.spec, x)
            aux = aux + a
        elif blk.kind == "mamba":
            x = SSM.mamba_apply(p, blk.spec, x)
    return x, aux


def stack_forward(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                  positions: torch.Tensor, *, remat: bool = True,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop the group program over the stacked params. Returns (x, aux),
    aux being the MoE aux loss summed over layers and groups (0 for
    stacks without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_g in _groups(params_stack):
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_group_body, blocks, x, positions, p_g, aux,
                                use_reentrant=False)
        else:
            x, aux = _group_body(blocks, x, positions, p_g, aux)
    return x, aux


# ---------------------------------------------------------------------------
# Prefill (returns decode caches) and decode
# ---------------------------------------------------------------------------

def stack_prefill(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                  positions: torch.Tensor, *,
                  cache_len: Optional[int] = None,
                  impl: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """Forward + per-layer cache construction. ``cache_len`` pads the KV
    caches with zeros to that many slots; Mamba layers keep their final
    state ``h`` and conv window."""
    B, S = x.shape[:2]
    groups = _groups(params_stack)
    cache = init_cache(blocks, len(groups), B, max(S, cache_len or 0),
                       x.dtype, x.device)
    for i, p_g in enumerate(groups):
        for blk in blocks:
            p = p_g[blk.name]
            if blk.kind == "attn":
                x, c = L.attn_prefill(p, blk.spec, x, positions=positions,
                                      impl=impl)
                for kk in ("k", "v"):
                    cache[blk.name][kk][i, :, :S] = c[kk]
            elif blk.kind == "mamba":
                x, c = SSM.mamba_prefill(p, blk.spec, x)
                for kk, t in c.items():
                    cache[blk.name][kk][i] = t
            elif blk.kind == "mlp":
                x = L.mlp_apply(p, blk.spec, x)
            elif blk.kind == "moe":
                x, _ = M.moe_apply(p, blk.spec, x)
    return x, cache


def stack_decode(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                 cache_stack: Params, pos: int, *,
                 impl: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """One-token decode through the stack. x: [B,1,d]. Writes slot ``pos``
    of every attention layer's cache and every Mamba layer's state in
    place; returns the same cache."""
    for i, p_g in enumerate(_groups(params_stack)):
        for blk in blocks:
            p = p_g[blk.name]
            if blk.kind in ("attn", "mamba"):
                c = {kk: t[i] for kk, t in cache_stack[blk.name].items()}
            if blk.kind == "attn":
                x, _ = L.attn_decode(p, blk.spec, x, c, pos, impl=impl)
            elif blk.kind == "mamba":
                x, _ = SSM.mamba_decode(p, blk.spec, x, c)
            elif blk.kind == "mlp":
                x = L.mlp_apply(p, blk.spec, x)
            elif blk.kind == "moe":
                x, _ = M.moe_apply(p, blk.spec, x)
    return x, cache_stack


# ---------------------------------------------------------------------------
# Cache construction + logical dims (for sharding)
# ---------------------------------------------------------------------------

def init_cache(blocks: List[Block], n_groups: int, batch: int,
               cache_len: int, dtype, device: Any) -> Params:
    """Zero-initialized decode cache (capacity ``cache_len``)."""
    out: Dict[str, Any] = {}
    for blk in blocks:
        if blk.kind == "attn":
            sp = blk.spec
            shape = (n_groups, batch, cache_len, sp.n_kv_heads, sp.head_dim)
            out[blk.name] = {kk: torch.zeros(shape, dtype=dtype,
                                             device=device)
                             for kk in ("k", "v")}
        elif blk.kind == "mamba":
            c = SSM.mamba_cache_init(blk.spec, batch, dtype, device)
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
        elif blk.kind == "mamba":
            out[blk.name] = {"h": ("layers", "batch", "ssm_inner", None),
                             "conv": ("layers", "batch", None, "ssm_inner")}
    return out
