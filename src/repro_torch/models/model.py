"""Model factory: ArchConfig -> Model (init / loss), dense decoders.

Port of the dense parts of ``repro/models/model.py``. The trainer builds
its step from ``model.loss``; the checkpoint service snapshots the
``{params, opt_state, step}`` tree produced here. Params are a plain
nested dict of tensors with the reference's names, shapes and stacked
``[n_groups, ...]`` layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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
        self.dtype = getattr(torch, self.cfg.dtype)
        self.vocab_padded = _pad_vocab(self.cfg.vocab_size)

    def init(self, gen: torch.Generator, device: Any = None) -> Params:
        """Params on ``device``: ``cuda`` unless ``"cpu"`` is asked for;
        with no GPU and no explicit request this raises."""
        cfg = self.cfg
        device = resolve_device(device)
        eb = L.ParamBuilder(gen, self.dtype, device)
        L.embed_init(eb, self.vocab_padded, cfg.d_model, cfg.tie_embeddings)
        eb.add("final_norm", (cfg.d_model,), ("embed_nt",), init="ones")
        stack = T.init_stack(gen, self.blocks, self.n_groups, self.dtype,
                             device)
        return {"embed": eb.params, "stack": stack}

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
             remat=True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x = L.embed_apply(params["embed"], batch["tokens"], self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = T.stack_forward(params["stack"], self.blocks, x, positions,
                                 remat=remat)
        x = L.rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], x, cfg.tie_embeddings)
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "moe_aux": aux}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
