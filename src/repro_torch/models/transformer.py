"""Decoder and encoder stacks built from block templates (``attn``,
``cross_attn``, ``mlp``, ``moe``, ``mamba``, ``mamba2``, ``mlstm`` and
``slstm``).

Port of ``repro/models/transformer.py``. An architecture is compiled into
a *group program*: the list of ``Block`` templates covering one period of
its layer pattern (e.g. jamba: ``[attn+mlp, mamba+moe, mamba+mlp, ...]``,
8 layers; xlstm: ``[mlstm, slstm]``; an enc-dec decoder layer:
``[attn, cross_attn, mlp]``; granite-4.0-h: ten layers of one mixer and
one MoE each, attention at ``attn_offset`` 5 and Mamba-2 elsewhere).
The stack keeps the reference's stacked layout — every leaf has a
leading ``[n_groups]`` dim, as ``init_stack``'s ``vmap`` makes it — so
images and converted inits carry over one to one.
The reference's ``lax.scan`` over groups becomes a Python loop over the
unbound stacked tensors, and its ``jax.checkpoint`` remat becomes
``torch.utils.checkpoint`` (neither changes a number): ``remat`` is
``True`` (each group remat'd whole), ``False``, or the reference's
selective policy ``"save_moe"``, under which each MoE layer's dispatched
rows and gathered expert output are kept for the backward
(``stack_forward``). Decode caches keep
the reference's stacked layout (``[n_groups, B, T, Hkv, hd]`` for k/v and
for the cross-attention memory ``mk``/``mv`` over ``T_enc`` slots; the
f32 recurrent states of Mamba and xLSTM beside their conv windows) and
block names, so a serving image crosses between the packages; decode
updates them in place.

Under ``sharding.specs.activation_sharding(axes, mesh)`` with a model
axis the stacks take this rank's param slices and build and update this
rank's cache slices (``cache_dims`` through ``leaf_spec``): the
attention, MLP and MoE blocks split their work (``layers``, ``moe``),
and so do the Mamba and xLSTM blocks (``ssm``, ``xlstm``): the Mamba
``h``/``conv`` and the mLSTM ``conv`` states are the rank's channels,
the mLSTM ``C``/``n`` and the sLSTM states whole. A serving batch that
the data axes do not divide is whole on every data rank, and the
attention caches are split over ``kvseq`` instead
(``specs.kvseq_active``): the prefill keeps each rank's slice of the
slots, the decode layers read and merge it; the recurrent states have
no ``kvseq`` dim and stay whole over the data ranks.

With ``sp`` (``specs.seq_split``: the reference's ``seq_shard``) the
training, encoder and prefill stacks carry ``x`` as this rank's rows of
the sequence between blocks: the attention and MLP blocks take it so
(``layers``), and the MoE, Mamba, mLSTM and sLSTM blocks run whole
through ``layers.whole_rows`` (gathered before, the rank's rows kept
after): the router's capacity positions and the recurrences see the
whole sequence, as the reference computes them. Decode is never split:
one token does not divide.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X
from repro_torch.sharding import specs as SH
from repro_torch.tree import map_dicts

Params = Any


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str  # attn | cross_attn | mlp | moe | mamba | mamba2 | mlstm | slstm
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
    res = cfg.residual_multiplier
    for j in range(gs):
        # --- token mixer ------------------------------------------------
        if cfg.attn_every > 1 and (j % cfg.attn_every) != cfg.attn_offset:
            if cfg.ssm.n_heads:
                blocks.append(Block("mamba2", f"l{j}_mamba2", SSM.Mamba2Spec(
                    cfg.d_model, cfg.ssm, cfg.norm_eps, res_mult=res)))
            else:
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
                cfg.rope_theta, cfg.norm_eps, window=window,
                use_rope=cfg.use_rope, scale=cfg.attn_scale,
                res_mult=res)))
            if cfg.encoder is not None:
                blocks.append(Block("cross_attn", f"l{j}_xattn", L.AttnSpec(
                    cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    cfg.rope_theta, cfg.norm_eps, cross=True,
                    use_rope=False)))
        # --- channel mixer ------------------------------------------------
        if cfg.moe is not None and (j % cfg.moe.every) == cfg.moe.every - 1:
            blocks.append(Block("moe", f"l{j}_moe", M.MoESpec(
                cfg.d_model, cfg.moe, cfg.mlp_act, cfg.norm_eps,
                d_ff_shared=cfg.d_ff if cfg.moe.shared_expert else 0,
                res_mult=res)))
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
    elif blk.kind == "mamba2":
        SSM.mamba2_init(b, blk.spec)
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


def _whole(fn, x: torch.Tensor, sp: bool):
    """A block that runs on the whole sequence: through
    ``layers.whole_rows`` over a sequence-split stream."""
    return L.whole_rows(fn, x) if sp else fn(x)


def _group_body(blocks: List[Block], x: torch.Tensor, positions: torch.Tensor,
                p_g: Dict[str, Dict[str, torch.Tensor]], aux: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None, sp: bool = False,
                kept: Optional[M.Kept] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One group's blocks. ``kept``: the group runs under
    ``remat="save_moe"``, and its MoE layers keep their boundary tensors
    there (``moe.Kept``)."""
    # ``kept`` is passed to a MoE block only when set, so a group outside
    # the policy calls every function as before
    kw = {}
    if kept is not None:
        kept.start()
        kw = {"kept": kept}
    for blk in SH.labelled(blocks):
        p = p_g[blk.name]
        if blk.kind == "attn":
            x = L.attn_apply(p, blk.spec, x, positions=positions, sp=sp)
        elif blk.kind == "cross_attn":
            mem = L.cross_attn_memory(p, blk.spec, enc_out)
            x = L.attn_apply(p, blk.spec, x, positions=positions, memory=mem,
                             sp=sp)
        elif blk.kind == "mlp":
            x = L.mlp_apply(p, blk.spec, x, sp=sp)
        elif blk.kind == "moe":
            x, a = _whole(lambda xw: M.moe_apply(p, blk.spec, xw, **kw),
                          x, sp)
            aux = aux + a
        elif blk.kind == "mamba":
            x = _whole(lambda xw: SSM.mamba_apply(p, blk.spec, xw), x, sp)
        elif blk.kind == "mamba2":
            x = _whole(lambda xw: SSM.mamba2_apply(p, blk.spec, xw), x, sp)
        elif blk.kind == "mlstm":
            x = _whole(lambda xw: X.mlstm_apply(p, blk.spec, xw), x, sp)
        elif blk.kind == "slstm":
            x = _whole(lambda xw: X.slstm_apply(p, blk.spec, xw), x, sp)
    return x, aux


REMAT_POLICIES = ("save_moe",)


def remat_policy(remat: Union[bool, str]) -> Union[bool, str]:
    """``remat`` checked: ``True`` (full remat), ``False`` (none) or a
    policy of ``REMAT_POLICIES``; any other string raises ``ValueError``
    (the reference takes an unknown string for full remat)."""
    if isinstance(remat, str) and remat not in REMAT_POLICIES:
        raise ValueError(f"remat policy {remat!r}: not one of "
                         f"{REMAT_POLICIES} (or True / False)")
    return remat


def stack_forward(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                  positions: torch.Tensor, *,
                  enc_out: Optional[torch.Tensor] = None,
                  remat: Union[bool, str] = True,
                  sp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop the group program over the stacked params. Returns (x, aux),
    aux being the MoE aux loss summed over layers and groups (0 for
    stacks without MoE). ``enc_out`` is the encoder's output, which the
    cross-attention blocks attend to. ``sp``: ``x`` is this rank's rows
    of a sequence-split stream (``positions`` the whole sequence's), and
    so is the result.

    ``remat`` (as the reference's, with autograd on): ``True`` remats
    each group whole (``torch.utils.checkpoint``: only its input is kept
    for the backward, and its forward runs again there); ``False`` keeps
    every activation; ``"save_moe"`` is the reference's selective remat
    (``jax.checkpoint_policies.save_only_these_names("moe_dispatch",
    "moe_expert_out")``): each group is remat'd whole as under ``True``,
    but its MoE layers' dispatched rows and expert output, gathered over
    ``ep``, are kept from the forward (``moe.Kept``), so the backward
    does not run the expert-parallel all-gather again; a group without
    MoE keeps nothing more. Any other string raises ``ValueError``."""
    remat = remat_policy(remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_g in _groups(params_stack):
        if not (remat and torch.is_grad_enabled()):
            x, aux = _group_body(blocks, x, positions, p_g, aux, enc_out, sp)
        else:
            kept = M.Kept() if remat == "save_moe" else None
            x, aux = checkpoint(_group_body, blocks, x, positions, p_g, aux,
                                enc_out, sp, kept, use_reentrant=False)
    return x, aux


def stack_encode(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                 positions: torch.Tensor, *,
                 impl: Optional[str] = None, sp: bool = False
                 ) -> torch.Tensor:
    """The encoder stack in serving (no autograd): its non-causal
    self-attention through the flash kernel, as a prefill without a
    cache. ``sp`` as in ``stack_forward``."""
    for p_g in _groups(params_stack):
        for blk in SH.labelled(blocks):
            p = p_g[blk.name]
            if blk.kind == "attn":
                x, _ = L.attn_prefill(p, blk.spec, x, positions=positions,
                                      impl=impl, sp=sp)
            elif blk.kind == "mlp":
                x = L.mlp_apply(p, blk.spec, x, sp=sp)
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
                  impl: Optional[str] = None,
                  sp: bool = False,
                  timer: Any = None) -> Tuple[torch.Tensor, Params]:
    """Forward + per-layer cache construction. ``cache_len`` pads the KV
    caches with zeros to that many slots; cross-attention layers keep the
    encoder memory ``mk``/``mv``; Mamba and xLSTM layers keep their final
    states. Where the serving call splits the caches over ``kvseq``
    (``specs.kvseq_active``) the prompt runs whole on every data rank,
    and each keeps its slice of the slots: the prompt's k/v at global
    slots [lo, min(S, hi)), the memory's [lo, hi). ``sp`` as in
    ``stack_forward``: the caches still hold the whole sequence.
    ``timer`` (an ``obs.timer.PhaseTimer``) times each block in a phase
    ``prefill/<kind>``."""
    B, S = x.shape[0], positions.shape[-1]
    groups = _groups(params_stack)
    T = max(S, cache_len or 0)
    cache = init_cache(blocks, len(groups), B, T, x.dtype, x.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    lo, hi = SH.kvseq_slice(T)
    n = max(0, min(S, hi) - lo)
    for i, p_g in enumerate(groups):
        for blk in SH.labelled(blocks):
            with (timer.phase(f"prefill/{blk.kind}") if timer is not None
                  else contextlib.nullcontext()):
                x = _prefill_block(blk, p_g[blk.name], x, positions, cache,
                                   i, lo, n, enc_out, impl, sp)
    return x, cache


def _prefill_block(blk: Block, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params, i: int, lo: int,
                   n: int, enc_out: Optional[torch.Tensor],
                   impl: Optional[str], sp: bool) -> torch.Tensor:
    """One block of group ``i`` in the prefill, its cache entries written
    into ``cache``."""
    c = None
    if blk.kind == "attn":
        x, kv = L.attn_prefill(p, blk.spec, x, positions=positions,
                               impl=impl, sp=sp)
        for kk in ("k", "v"):
            cache[blk.name][kk][i, :, :n] = kv[kk][:, lo:lo + n]
    elif blk.kind == "cross_attn":
        mem = L.cross_attn_memory(p, blk.spec, enc_out)
        x = L.cross_attn_prefill(p, blk.spec, x, mem, impl=impl,
                                 sp=sp)
        c = L.cross_attn_cache(blk.spec, mem)
    elif blk.kind == "mamba":
        x, c = _whole(lambda xw: SSM.mamba_prefill(p, blk.spec, xw),
                      x, sp)
    elif blk.kind == "mamba2":
        x, c = _whole(lambda xw: SSM.mamba2_prefill(p, blk.spec, xw),
                      x, sp)
    elif blk.kind == "mlstm":
        x, c = _whole(lambda xw: X.mlstm_prefill(p, blk.spec, xw),
                      x, sp)
    elif blk.kind == "slstm":
        x, c = _whole(lambda xw: X.slstm_prefill(p, blk.spec, xw),
                      x, sp)
    elif blk.kind == "mlp":
        x = L.mlp_apply(p, blk.spec, x, sp=sp)
    elif blk.kind == "moe":
        x, _ = _whole(lambda xw: M.moe_apply(p, blk.spec, xw), x, sp)
    if c is not None:
        for kk, t in c.items():
            cache[blk.name][kk][i] = t
    return x


def stack_decode(params_stack: Params, blocks: List[Block], x: torch.Tensor,
                 cache_stack: Params, pos: Union[int, torch.Tensor], *,
                 impl: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """One-token decode through the stack. x: [B,1,d]. Writes slot ``pos``
    of every attention layer's cache and every Mamba and xLSTM layer's
    state in place (the cross-attention memory is only read); returns the
    same cache. ``pos`` as ``layers.attn_decode`` takes it."""
    for i, p_g in enumerate(_groups(params_stack)):
        for blk in SH.labelled(blocks):
            p = p_g[blk.name]
            if blk.name in cache_stack:
                c = {kk: SH.kvseq_layer(t, i)
                     for kk, t in cache_stack[blk.name].items()}
            if blk.kind == "attn":
                x, _ = L.attn_decode(p, blk.spec, x, c, pos, impl=impl)
            elif blk.kind == "cross_attn":
                x = L.cross_attn_decode(p, blk.spec, x, (c["mk"], c["mv"]),
                                        impl=impl)
            elif blk.kind == "mamba":
                x, _ = SSM.mamba_decode(p, blk.spec, x, c)
            elif blk.kind == "mamba2":
                x, _ = SSM.mamba2_decode(p, blk.spec, x, c)
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
    cross-attention memory holds ``enc_len`` slots). ``batch`` is the
    rows this rank holds (the whole batch where the serving call splits
    the caches over ``kvseq``); in a split context the KV caches and the
    recurrent states are this rank's slices (``cache_dims`` through
    ``leaf_spec``), the attention caches marked with their global slots
    (``specs.kvseq_mark``). The Mamba and xLSTM states have no ``kvseq`` dim:
    with a replicated batch they are whole on every data rank, as
    ``leaf_spec`` lays them out."""
    out: Dict[str, Any] = {}
    kvseq = SH.kvseq_active()
    for blk in blocks:
        if blk.kind in ("attn", "cross_attn"):
            sp = blk.spec
            n = enc_len if blk.kind == "cross_attn" else cache_len
            shape = (n_groups, batch, n, sp.n_kv_heads, sp.head_dim)
            if SH.tp_size() > 1 or kvseq:
                dims = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
                whole = (n_groups, batch if kvseq else batch * SH.dp_size(),
                         n, sp.n_kv_heads, sp.head_dim)
                shape = SH.local_shape(SH.active_leaf_spec(dims, whole),
                                       whole)
            out[blk.name] = {kk: SH.kvseq_mark(torch.zeros(
                shape, dtype=dtype, device=device), n) if kvseq else
                torch.zeros(shape, dtype=dtype, device=device)
                for kk in (("mk", "mv") if sp.cross else ("k", "v"))}
            continue
        init = {"mamba": SSM.mamba_cache_init,
                "mamba2": SSM.mamba2_cache_init, "mlstm": X.mlstm_cache_init,
                "slstm": X.slstm_cache_init}.get(blk.kind)
        if init is None:
            continue
        dims = cache_dims([blk])[blk.name]   # the rank's channels, if split
        out[blk.name] = {kk: torch.zeros(
            (n_groups,) + _local_state(dims[kk][1:], t.shape),
            dtype=t.dtype, device=device)
            for kk, t in init(blk.spec, batch, dtype, "meta").items()}
    return out


def _local_state(dims: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A recurrent state's shape on this rank: ``shape`` has this rank's
    rows already, and ``leaf_spec`` splits its channel dims."""
    dims = tuple(None if n == "batch" else n for n in dims)
    return SH.local_shape(SH.active_leaf_spec(dims, tuple(shape)), shape)


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
        elif blk.kind == "mamba2":
            out[blk.name] = {"h": ("layers", "batch", None, None, None),
                             "conv": ("layers", "batch", None, None)}
        elif blk.kind == "mlstm":
            out[blk.name] = {"C": ("layers", "batch", None, "head_dim", None),
                             "n": ("layers", "batch", None, "head_dim"),
                             "conv": ("layers", "batch", None, "xl_inner")}
        elif blk.kind == "slstm":
            d = ("layers", "batch", "embed_nt")
            out[blk.name] = {k: d for k in ("c", "n", "h", "m")}
    return out
