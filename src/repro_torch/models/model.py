"""Model factory: ArchConfig -> Model (init / loss / prefill / decode) for
every family of the reference: dense, MoE, hybrid Mamba + attention,
xLSTM, encoder-decoder and the vision-language frontend.

Port of ``repro/models/model.py``. The loss is ``ce + 0.01 * aux``, aux
being the MoE layers' load-balancing loss (0 without MoE). An enc-dec
model's encoder (its own ``stack`` and ``final_norm`` under
``params["encoder"]``) reads ``frames``, and its decoder's cross-attention
reads the encoder's output; a vlm prepends ``patch_embeds`` to the token
embeddings, positions running over both. The trainer builds its step from
``model.loss``; the checkpoint service snapshots the ``{params,
opt_state, step}`` tree produced here; the serving engine runs
``prefill`` and ``decode_step`` over the cache of ``init_cache``. Params
are a plain nested dict of tensors with the reference's names, shapes and
stacked ``[n_groups, ...]`` layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Any


def _pad_vocab(v: int) -> int:
    return ((v + 255) // 256) * 256


class _CrossEntropy(torch.autograd.Function):
    """Masked token CE. targets: int, -1 = ignore.

    Dtype-preserving, as the reference's custom VJP: every [B,S,V]-shaped
    tensor (exp, softmax, one-hot, d_logits) stays in the compute dtype;
    only scalar/[B,S] reductions run in f32. The backward is the explicit
    one-hot formula (a comparison with ``arange``, no scatter), so it is
    deterministic on the card.
    """

    @staticmethod
    def forward(ctx, logits, targets):
        m = logits.amax(dim=-1, keepdim=True)            # compute dtype
        ex = torch.exp(logits - m)                       # compute dtype
        sumexp = ex.float().sum(dim=-1)                  # f32 [B,S]
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
        inv = (1.0 / sumexp).to(dt)[..., None]           # [B,S,1]
        scale = (g * mask / n).to(dt)[..., None]         # [B,S,1]
        vocab = torch.arange(ex.shape[-1], device=ex.device)
        onehot = (tgt[..., None] == vocab).to(dt)
        d_logits = (ex * inv - onehot) * scale           # compute dtype
        return d_logits, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _CrossEntropy.apply(logits, targets)


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

    def abstract_params(self) -> Params:
        """The params' shapes and dtypes as ``meta`` tensors: nothing drawn
        or allocated (``jax.eval_shape``'s counterpart)."""
        return self._build(None, torch.device("meta"))

    # ------------------------------------------------------------------
    # Shared embedding / frontend handling
    # ------------------------------------------------------------------
    def _encoder_forward(self, params: Params, frames: torch.Tensor, *,
                         remat: bool = True, serve: bool = False,
                         impl: Optional[str] = None) -> torch.Tensor:
        """The enc-dec encoder over ``frames`` [B,F,d]. In training its
        attention is ``attention_ref`` with its autograd; in serving
        (``serve``) it runs through the flash kernel."""
        enc = params["encoder"]
        x = frames.to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        if serve:
            x = T.stack_encode(enc["stack"], self.enc_blocks, x, positions,
                               impl=impl)
        else:
            x, _ = T.stack_forward(enc["stack"], self.enc_blocks, x,
                                   positions, remat=remat)
        return L.rmsnorm(x, enc["final_norm"], self.cfg.norm_eps)

    def _inputs(self, params: Params, batch: Dict[str, torch.Tensor], *,
                remat: bool = True, serve: bool = False,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """-> (x [B,S,d], positions [S], enc_out or None)."""
        cfg = self.cfg
        enc_out = None
        x = L.embed_apply(params["embed"], batch["tokens"], self.dtype)
        if cfg.family == "encdec":
            enc_out = self._encoder_forward(params, batch["frames"],
                                            remat=remat, serve=serve,
                                            impl=impl)
        elif cfg.frontend is not None:           # vlm: prepend patch embeds
            x = torch.cat([batch["patch_embeds"].to(self.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions, enc_out

    # ------------------------------------------------------------------
    # Training loss
    # ------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
             remat=True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x, positions, enc_out = self._inputs(params, batch, remat=remat)
        x, aux = T.stack_forward(params["stack"], self.blocks, x, positions,
                                 enc_out=enc_out, remat=remat)
        x = L.rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], x, cfg.tie_embeddings)
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "moe_aux": aux}

    # ------------------------------------------------------------------
    # Serving (no autograd: neither attention kernel has a backward)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                cache_len: Optional[int] = None, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Params]:
        """Run the prompt; returns (last-position logits [B,V], cache).
        An enc-dec model's encoder runs here too, through the flash
        kernel; a vlm's prompt is its ``frontend_len`` patch embeddings,
        then its tokens."""
        cfg = self.cfg
        x, positions, enc_out = self._inputs(params, batch, serve=True,
                                             impl=impl)
        x, cache = T.stack_prefill(params["stack"], self.blocks, x,
                                   positions, enc_out=enc_out,
                                   cache_len=cache_len, impl=impl)
        x = L.rmsnorm(x[:, -1:], params["embed"]["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], x, cfg.tie_embeddings)
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Params, token: torch.Tensor,
                    pos: int, *, impl: Optional[str] = None,
                    ) -> Tuple[torch.Tensor, Params]:
        """token: [B,1] int; pos: int. -> (logits [B,V], cache). Writes
        slot ``pos`` of ``cache`` in place and returns it."""
        cfg = self.cfg
        x = L.embed_apply(params["embed"], token, self.dtype)
        x, cache = T.stack_decode(params["stack"], self.blocks, x, cache,
                                  pos, impl=impl)
        x = L.rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], x, cfg.tie_embeddings)
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
