"""AdamW + LR schedules + global-norm clipping, written by hand over the
param tree (port of ``repro/train/optimizer.py``; not ``torch.optim``).

State layout mirrors the param tree ({"m": ..., "v": ...} + scalar count),
so the checkpoint substrate saves it with the same names as the reference.
The update is functional: it returns new tensors and never writes into a
tensor it was given, so a snapshot that pinned the previous state stays
that state (the trainer relies on this).

Every quirk of the reference is kept: warmup + cosine/linear schedule
evaluated in f32 on the device, clipping by the global norm of all
grads, bias correction, and weight decay on every leaf with ``ndim >= 2``
— which, the leaves being stacked ``[n_groups, ...]``, includes the
``[n_groups, d]`` norm weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp_max((step + 1.0) / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_init(params: Params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, opt_state: Dict[str, Any],
                 params: Params) -> Tuple[Params, Dict[str, Any],
                                          Dict[str, torch.Tensor]]:
    """-> (new_params, new_opt_state, metrics)."""
    return adamw_apply(cfg, grads, opt_state, params, global_norm(grads))


@torch.no_grad()
def adamw_apply(cfg: AdamWConfig, grads: Params, opt_state: Dict[str, Any],
                params: Params, gnorm: torch.Tensor
                ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """``adamw_update`` with the clip norm given: the sharded step passes
    the whole gradient's norm and updates each rank's slices of params,
    grads and moments, elementwise as the whole update would."""
    count = opt_state["count"] + 1
    if cfg.grad_clip > 0:
        scale = torch.where(gnorm > cfg.grad_clip,
                            cfg.grad_clip / (gnorm + 1e-9),
                            torch.ones_like(gnorm))
    else:
        scale = 1.0
    lr = lr_at(cfg, opt_state["count"])
    c = count.float()
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c

    def upd(g, m, v, p):
        gf = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.dim() >= 2 else 0.0
        p_new = p.float() - lr * (step + decay)
        return p_new.to(p.dtype), m_new, v_new

    out = []
    tree_map(lambda *leaves: out.append(upd(*leaves)), grads,
             opt_state["m"], opt_state["v"], params)
    new_p, new_m, new_v = (tree_unflatten(params, [o[j] for o in out])
                           for j in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics


def opt_state_dims(param_dims: Any) -> Any:
    """Logical dims for the optimizer state (moments mirror params)."""
    return {"m": param_dims, "v": param_dims, "count": ()}
