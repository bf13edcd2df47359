"""Model factory: ArchConfig -> Model (init / loss / prefill / decode) for
every family of the reference: dense, MoE, hybrid Mamba + attention,
xLSTM, encoder-decoder and the vision-language frontend.

Port of ``repro/models/model.py``. The loss is ``ce + 0.01 * aux``, aux
being the MoE layers' load-balancing loss (0 without MoE). An enc-dec
model's encoder (its own ``stack`` and ``final_norm`` under
``params["encoder"]``) reads ``frames``, and its decoder's cross-attention
reads the encoder's output; a vlm prepends ``patch_embeds`` to the token
embeddings, positions running over both. Granite's multipliers scale the
token embeddings (``embedding_multiplier``) and divide the logits
(``logits_scaling``); its ``residual_multiplier`` lives in the blocks.
The trainer builds its step from ``model.loss``; the checkpoint service
snapshots the ``{params, opt_state, step}`` tree produced here; the
serving engine runs ``prefill`` and ``decode_step`` over the cache of
``init_cache``. Params are a plain nested dict of tensors with the
reference's names, shapes and stacked ``[n_groups, ...]`` layout.

Under ``sharding.specs.activation_sharding(axes, mesh)`` the forward is
split over the mesh as the reference's ``constrain`` has GSPMD split it:
each data-parallel rank computes its rows of the batch, and each rank of
the model axis its slices of heads, ``ff``, experts and vocab and its
channels of the Mamba and xLSTM blocks (see ``layers``, ``moe``,
``ssm``, ``xlstm``, ``transformer``). The loss is then this rank's
share of the batch's: ``ce`` is its rows' Σ nll·mask over the whole
batch's count of targets, so the shares add up over the data-parallel
ranks to the batch's masked mean, and ``moe_aux`` is the whole batch's.
``prefill`` and ``decode_step`` take params and caches whose leaves are
DTensors laid out by ``param_specs(param_dims())`` and
``param_specs(cache_dims())`` (``cache_specs``), or this rank's slices
of them, and return logits that are whole on every rank and this rank's
cache slices. A serving batch that the data axes do not divide (batch 1
on several data ranks, as ``long_500k``) is replicated, as the
reference's ``constrain`` leaves a dim it cannot divide, and the
attention caches are split over ``kvseq`` instead (the context-parallel
decode: ``specs.serving_batch``, ``layers._cp_decode``); a cache whose
slots the data ranks do not divide either stays whole on each, as
``leaf_spec`` keeps it; its tensors carry their global slot count to the
decode steps that follow (``specs.kvseq_mark``).

Sequence sharding (``make_axes(mesh, seq_shard=True)``; the reference's
``constrain(x, ("dp", "sp", None))`` at the block boundaries). Where
``specs.seq_split`` says the sequence divides over the model axis,
``_inputs`` cuts the stream to this rank's rows (the embedding
reduce-scatters its lookup; a vlm's stream is cut after the concat, an
enc-dec encoder's frames before its stack), the stacks carry the rows,
the final norm runs on them (its weight entered with ``copy_to_tp``),
and the unembedding gathers them: the CE sees the whole sequence, as
before. The encoder's output is gathered once after its final norm.
A prefill takes its last position from the rank that holds it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.obs.counts import CountSet
from repro_torch.sharding import specs as SH
from repro_torch.tree import tree_map

Params = Any


def _pad_vocab(v: int) -> int:
    return ((v + 255) // 256) * 256


class _CrossEntropy(torch.autograd.Function):
    """Masked token CE. targets: int, -1 = ignore.

    Dtype-preserving, as the reference's custom VJP: every [B,S,V]-shaped
    tensor (exp, softmax, one-hot, d_logits) stays in the compute dtype;
    only scalar/[B,S] reductions run in f32. The backward is the explicit
    one-hot formula (a comparison with ``arange``, no scatter), so it is
    deterministic on the card. ``n``, when given, is the count of targets
    to divide by (the whole batch's, where this call sees some of its
    rows); by default the count of ``targets``.

    Vocab-parallel: ``logits`` are this rank's columns of the vocab,
    starting at ``v0``; under a split vocab the row max, the Σexp and the
    target's logit are all-reduced over the tensor-parallel ranks, and
    the backward stays local (each rank's columns of d_logits). Without
    a tensor-parallel group (``v0`` = 0) the all-reduces are the identity
    and the arithmetic is the one-process CE's.
    """

    @staticmethod
    def forward(ctx, logits, targets, n, v0):
        V = logits.shape[-1]
        m = SH.tp_all_reduce(logits.amax(dim=-1, keepdim=True).float(),
                             dist.ReduceOp.MAX).to(logits.dtype)
        ex = torch.exp(logits - m)                       # compute dtype
        sumexp = SH.tp_all_reduce(ex.float().sum(dim=-1))   # f32 [B,S]
        lse = m[..., 0].float() + torch.log(sumexp)
        local = targets.long() - v0
        inside = (local >= 0) & (local < V) & (targets >= 0)
        tgt = torch.clamp(local, 0, V - 1)
        tl = torch.gather(logits, -1, tgt[..., None])[..., 0].float()
        tl = SH.tp_all_reduce(tl * inside)
        nll = lse - tl
        mask = (targets >= 0).float()
        n = torch.clamp_min(mask.sum() if n is None else n, 1.0)
        loss = (nll * mask).sum() / n
        ctx.save_for_backward(ex, sumexp, tgt, inside, mask, n)
        return loss

    @staticmethod
    def backward(ctx, g):
        ex, sumexp, tgt, inside, mask, n = ctx.saved_tensors
        dt = ex.dtype
        inv = (1.0 / sumexp).to(dt)[..., None]           # [B,S,1]
        scale = (g * mask / n).to(dt)[..., None]         # [B,S,1]
        vocab = torch.arange(ex.shape[-1], device=ex.device)
        onehot = ((tgt[..., None] == vocab) & inside[..., None]).to(dt)
        d_logits = (ex * inv - onehot) * scale           # compute dtype
        return d_logits, None, None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Masked token CE over the batch. Under a split context this rank's
    share: its rows over the whole batch's count of targets (summed over
    the data-parallel ranks), and, when ``vocab`` (the padded vocab) is
    split over the tensor-parallel ranks, the vocab-parallel form."""
    n = None
    if SH.dp_size() > 1:
        n = SH.dp_all_reduce((targets >= 0).sum().float())
    return _CrossEntropy.apply(logits, targets, n,
                               L.vocab_start(vocab) or 0)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        self.blocks, self.n_groups = T.build_group(self.cfg)
        if self.cfg.encoder is not None:
            self.enc_blocks, self.enc_groups = T.build_encoder_group(self.cfg)
        else:
            self.enc_blocks, self.enc_groups = None, 0
        self.dtype = getattr(torch, self.cfg.dtype)
        self.vocab_padded = _pad_vocab(self.cfg.vocab_size)

    def init(self, gen: torch.Generator, device: Any = None) -> Params:
        """Params on ``device``: ``cuda`` unless ``"cpu"`` is asked for;
        with no GPU and no explicit request this raises."""
        return self._build(gen, resolve_device(device))

    def _build(self, gen: Optional[torch.Generator],
               device: torch.device) -> Params:
        cfg = self.cfg
        eb = L.ParamBuilder(gen, self.dtype, device)
        L.embed_init(eb, self.vocab_padded, cfg.d_model, cfg.tie_embeddings)
        eb.add("final_norm", (cfg.d_model,), ("embed_nt",), init="ones")
        stack = T.init_stack(gen, self.blocks, self.n_groups, self.dtype,
                             device)
        params = {"embed": eb.params, "stack": stack}
        if self.enc_blocks is not None:
            enc_stack = T.init_stack(gen, self.enc_blocks, self.enc_groups,
                                     self.dtype, device)
            enb = L.ParamBuilder(gen, self.dtype, device)
            enb.add("final_norm", (cfg.d_model,), ("embed_nt",), init="ones")
            params["encoder"] = {"stack": enc_stack, **enb.params}
        return params

    def param_dims(self) -> Any:
        """Logical-dims tree matching ``init`` output (no allocation)."""
        cfg = self.cfg
        dims_embed = {"embedding": ("vocab", "embed"),
                      "final_norm": ("embed_nt",)}
        if not cfg.tie_embeddings:
            dims_embed["unembed"] = ("embed", "vocab")
        dims = {"embed": dims_embed, "stack": T.stack_dims(self.blocks)}
        if self.enc_blocks is not None:
            dims["encoder"] = {"stack": T.stack_dims(self.enc_blocks),
                               "final_norm": ("embed_nt",)}
        return dims

    def split_axes(self) -> Tuple[str, ...]:
        """The mesh axes every param leaf stays split over in the split
        forward: the active context's ``tp`` and ``ep`` axes; none
        outside a context."""
        axes = SH.active_axes()
        return () if axes is None else tuple(dict.fromkeys(
            a for a in (axes.tp, axes.ep) if a is not None))

    def local_params(self, params: Params) -> Params:
        """This rank's view of ``params`` for the split forward: a DTensor
        leaf gathered over every mesh dim but those ``split_axes`` names;
        a plain tensor is taken as the slice the forward needs."""
        keep = self.split_axes()
        return tree_map(lambda t: SH.gather_except(t, keep)
                        if isinstance(t, DTensor) else t, params)

    def abstract_params(self) -> Params:
        """The params' shapes and dtypes as ``meta`` tensors: nothing drawn
        or allocated (``jax.eval_shape``'s counterpart)."""
        return self._build(None, torch.device("meta"))

    # ------------------------------------------------------------------
    # Shared embedding / frontend handling
    # ------------------------------------------------------------------
    def _encoder_forward(self, params: Params, frames: torch.Tensor, *,
                         remat: Union[bool, str] = True,
                         serve: bool = False,
                         impl: Optional[str] = None) -> torch.Tensor:
        """The enc-dec encoder over ``frames`` [B,F,d]. In training its
        attention is ``attention_ref`` with its autograd (it has no MoE,
        so ``remat="save_moe"`` remats it whole, as the reference's scan
        does); in serving (``serve``) it runs through the flash
        kernel."""
        enc = params["encoder"]
        x = frames.to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        sp = SH.seq_split(x)
        if sp:
            x = SH.scatter_to_sp(x)
        if serve:
            x = T.stack_encode(enc["stack"], self.enc_blocks, x, positions,
                               impl=impl, sp=sp)
        else:
            x, _ = T.stack_forward(enc["stack"], self.enc_blocks, x,
                                   positions, remat=remat, sp=sp)
        if not sp:
            return L.rmsnorm(x, enc["final_norm"], self.cfg.norm_eps)
        # the memory is read whole by every cross-attention layer, whose
        # copy_to_tp sums its gradient: the gather keeps the rank's rows
        x = L.rmsnorm(x, SH.copy_to_tp(enc["final_norm"]), self.cfg.norm_eps)
        return SH.gather_from_tp(x, 1)

    def _inputs(self, params: Params, batch: Dict[str, torch.Tensor], *,
                remat: Union[bool, str] = True, serve: bool = False,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                           bool]:
        """-> (x [B,S,d], positions [S], enc_out or None, sp). ``sp``: the
        stream is sequence-split (``specs.seq_split``), and ``x`` is this
        rank's rows [B, S/tp, d]; ``positions`` are the whole
        sequence's."""
        cfg = self.cfg
        enc_out = None
        tokens = batch["tokens"]
        vlm = cfg.family != "encdec" and cfg.frontend is not None
        S = tokens.shape[1] + (batch["patch_embeds"].shape[1] if vlm else 0)
        sp = SH.seq_split((tokens.shape[0], S, cfg.d_model))
        x = self._embed(params, tokens, sp=sp and not vlm)
        if cfg.family == "encdec":
            enc_out = self._encoder_forward(params, batch["frames"],
                                            remat=remat, serve=serve,
                                            impl=impl)
        elif vlm:                                # prepend patch embeds
            x = torch.cat([batch["patch_embeds"].to(self.dtype), x], dim=1)
            if sp:
                x = SH.scatter_to_sp(x)
        positions = torch.arange(S, device=x.device)
        return x, positions, enc_out, sp

    def _embed(self, params: Params, tokens: torch.Tensor,
               sp: bool = False) -> torch.Tensor:
        x = L.embed_apply(params["embed"], tokens, self.dtype,
                          vocab=self.vocab_padded, sp=sp)
        m = self.cfg.embedding_multiplier
        return x if m == 1.0 else x * m

    def _logits(self, params: Params, x: torch.Tensor,
                sp: bool = False) -> torch.Tensor:
        logits = L.unembed_apply(params["embed"], x, self.cfg.tie_embeddings,
                                 vocab=self.vocab_padded, sp=sp)
        s = self.cfg.logits_scaling
        return logits if s == 1.0 else logits / s

    # ------------------------------------------------------------------
    # Training loss
    # ------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
             remat: Union[bool, str] = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x, positions, enc_out, sp = self._inputs(params, batch, remat=remat)
        x, aux = T.stack_forward(params["stack"], self.blocks, x, positions,
                                 enc_out=enc_out, remat=remat, sp=sp)
        w = params["embed"]["final_norm"]
        x = L.rmsnorm(x, SH.copy_to_tp(w) if sp else w, cfg.norm_eps)
        logits = self._logits(params, x, sp=sp)
        ce = cross_entropy(logits, batch["targets"], self.vocab_padded)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "moe_aux": aux}

    # ------------------------------------------------------------------
    # Serving (no autograd)
    # ------------------------------------------------------------------
    def _split(self) -> bool:
        return SH.tp_size() > 1 or SH.dp_size() > 1

    def _rows(self, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a serving batch; the whole batch, replicated,
        where it does not divide the data axes (``SH.kvseq_split``: the
        caches are then split over ``kvseq``)."""
        B = next(iter(batch.values())).shape[0]
        if SH.kvseq_split(B):
            return batch
        lo, hi = SH.dp_slice(B)
        return {k: v[lo:hi] for k, v in batch.items()}

    def _whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's [rows, vocab slice] of the logits -> the whole
        [B, V] on every rank (a replicated batch's rows are whole
        already)."""
        if L.vocab_start(self.vocab_padded) is not None:
            logits = SH.gather_from_tp(logits, -1)
        if SH.kvseq_active():
            return logits
        return SH.dp_gather(logits, 0)

    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                cache_len: Optional[int] = None, impl: Optional[str] = None,
                timer: Any = None) -> Tuple[torch.Tensor, Params]:
        """Run the prompt; returns (last-position logits [B,V], cache).
        An enc-dec model's encoder runs here too, through the flash
        kernel; a vlm's prompt is its ``frontend_len`` patch embeddings,
        then its tokens. ``timer`` (an ``obs.timer.PhaseTimer``) times each
        decoder block (``transformer.stack_prefill``)."""
        B = next(iter(batch.values())).shape[0]
        with SH.serving_batch(B):
            return self._prefill(params, batch, cache_len, impl, timer)

    def _prefill(self, params, batch, cache_len, impl, timer=None):
        cfg = self.cfg
        split = self._split()
        if split:
            params, batch = self.local_params(params), self._rows(batch)
        x, positions, enc_out, sp = self._inputs(params, batch, serve=True,
                                                 impl=impl)
        x, cache = T.stack_prefill(params["stack"], self.blocks, x,
                                   positions, enc_out=enc_out,
                                   cache_len=cache_len, impl=impl, sp=sp,
                                   timer=timer)
        x = x[:, -1:]
        if sp:      # the last rank's last row: each rank's last, gathered
            x = SH.gather_from_tp(x, 1)[:, -1:]
        x = L.rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)
        if split:
            return self._whole_logits(logits[:, 0]), cache
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Params, token: torch.Tensor,
                    pos: Union[int, torch.Tensor], *,
                    impl: Optional[str] = None,
                    ) -> Tuple[torch.Tensor, Params]:
        """token: [B,1] int; pos: int, or, unsplit, a 0-d int32 tensor on
        the token's device (the host never reads it: a step captured in a
        CUDA graph). -> (logits [B,V], cache). Writes slot ``pos`` of
        ``cache`` in place and returns it."""
        with SH.serving_batch(token.shape[0]):
            return self._decode_step(params, cache, token, pos, impl)

    def decode_counts(self) -> CountSet:
        """Every count a decode step split over no mesh adds to, as its
        blocks' modules name them (``layers.decode_counter``,
        ``moe.COUNTERS``): what a replay of a captured step adds."""
        found = []
        for blk in self.blocks:
            if blk.kind in ("attn", "cross_attn"):
                found.append(L.decode_counter(blk.spec))
            found += M.COUNTERS if blk.kind == "moe" else ()
        return CountSet(c for i, c in enumerate(found) if c not in found[:i])

    def _decode_step(self, params, cache, token, pos, impl):
        cfg = self.cfg
        split = self._split()
        if split:
            params = self.local_params(params)
            # a DTensor's local tensor keeps its global slots, which say
            # whether a kvseq split holds it whole or split
            cache = tree_map(lambda t: SH.kvseq_mark(t.to_local(),
                                                     t.shape[2])
                             if isinstance(t, DTensor) else t, cache)
            token = self._rows({"t": token})["t"]
        x = self._embed(params, token)
        x, cache = T.stack_decode(params["stack"], self.blocks, x, cache,
                                  pos, impl=impl)
        x = L.rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)
        if split:
            return self._whole_logits(logits[:, 0]), cache
        return logits[:, 0], cache

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   device: Any = None) -> Params:
        """Zero decode cache on ``device``: ``cuda`` unless ``"cpu"`` is
        asked for; with no GPU and no explicit request this raises. An
        enc-dec model's cross-attention memory holds ``frontend_len``
        slots."""
        enc_len = self.cfg.frontend_len if self.cfg.family == "encdec" else 0
        return T.init_cache(self.blocks, self.n_groups, batch, cache_len,
                            self.dtype, resolve_device(device),
                            enc_len=enc_len)

    def cache_dims(self) -> Any:
        return T.cache_dims(self.blocks)

    def cache_specs(self, cache: Params, axes: SH.MeshAxes) -> Any:
        """How ``cache`` (of the global batch and slots; shapes, or
        ``meta`` tensors) is laid out on a mesh of ``axes``:
        ``param_specs(cache_dims())`` (a batch that the data axes do not
        divide leaves them to ``kvseq``)."""
        return SH.param_specs(self.cache_dims(), cache, axes)

    # ------------------------------------------------------------------
    # Batch construction (synthetic shapes; the data pipeline mirrors this)
    # ------------------------------------------------------------------
    def batch_struct(self, global_batch: int,
                     seq_len: int) -> Dict[str, torch.Tensor]:
        """One training batch's shapes and dtypes, as ``meta`` tensors."""
        cfg = self.cfg
        B, S = global_batch, seq_len
        sds = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
        if cfg.family == "encdec":
            return {
                "frames": sds((B, cfg.frontend_len, cfg.d_model), self.dtype),
                "tokens": sds((B, S), torch.int32),
                "targets": sds((B, S), torch.int32),
            }
        if cfg.frontend is not None:
            F = cfg.frontend_len
            return {
                "patch_embeds": sds((B, F, cfg.d_model), self.dtype),
                "tokens": sds((B, S - F), torch.int32),
                "targets": sds((B, S), torch.int32),
            }
        return {"tokens": sds((B, S), torch.int32),
                "targets": sds((B, S), torch.int32)}

    def batch_dims(self) -> Dict[str, Tuple]:
        cfg = self.cfg
        out = {"tokens": ("batch", None), "targets": ("batch", None)}
        if cfg.family == "encdec":
            out["frames"] = ("batch", None, None)
        elif cfg.frontend is not None:
            out["patch_embeds"] = ("batch", None, None)
        return out


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
