"""Decoder stacks built from block templates (dense ``attn`` + ``mlp``).

Port of ``repro/models/transformer.py`` for the dense blocks. An
architecture is compiled into a *group program*: the list of ``Block``
templates covering one period of its layer pattern. The stack keeps the
reference's stacked layout — every leaf has a leading ``[n_groups]`` dim,
as ``init_stack``'s ``vmap`` makes it — so images and converted inits
carry over one to one. The reference's ``lax.scan`` over groups becomes a
Python loop over the unbound stacked tensors, and its ``jax.checkpoint``
remat becomes ``torch.utils.checkpoint`` (neither changes a number).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.tree import map_dicts

Params = Any


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str            # attn | mlp
    name: str
    spec: Any


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_group(cfg: ArchConfig) -> Tuple[List[Block], int]:
    """One period of the layer pattern + how many times it repeats."""
    if (cfg.xlstm is not None or cfg.moe is not None or cfg.attn_every > 1
            or cfg.encoder is not None or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.name}: only dense attn+mlp stacks are ported so far")
    gs = 1
    if cfg.attn_pattern == "local_global":
        gs = _lcm(gs, cfg.local_global_ratio + 1)
    assert cfg.n_layers % gs == 0, (cfg.name, cfg.n_layers, gs)

    blocks = []
    for j in range(gs):
        window = None
        if cfg.attn_pattern == "local_global":
            r = cfg.local_global_ratio
            if (j % (r + 1)) != r:            # last of each sub-period = global
                window = cfg.local_window
        blocks.append(Block("attn", f"l{j}_attn", L.AttnSpec(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.rope_theta, cfg.norm_eps, window=window)))
        if cfg.d_ff > 0:
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
    else:
        raise ValueError(blk.kind)


def _stack_trees(trees: List[Any]) -> Any:
    """Stack per-group dicts leaf by leaf, keys in sorted order (the order
    the reference's ``vmap`` output has)."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees])
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

def _group_body(blocks: List[Block], x: torch.Tensor, positions: torch.Tensor,
                p_g: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    for blk in blocks:
        p = p_g[blk.name]
        if blk.kind == "attn":
            x = L.attn_apply(p, blk.spec, x, positions=positions)
        elif blk.kind == "mlp":
            x = L.mlp_apply(p, blk.spec, x)
    return x


def stack_forward(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                  positions: torch.Tensor, *, remat: bool = True,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop the group program over the stacked params. Returns (x, aux),
    aux being the reference's MoE aux loss: 0 for dense stacks."""
    # unbind once per leaf: its backward stacks the per-group grads in one op
    unbound = map_dicts(lambda t: t.unbind(0), params_stack)
    n = len(next(iter(next(iter(unbound.values())).values())))
    for i in range(n):
        p_g = map_dicts(lambda ts, i=i: ts[i], unbound)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_group_body, blocks, x, positions, p_g,
                           use_reentrant=False)
        else:
            x = _group_body(blocks, x, positions, p_g)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
