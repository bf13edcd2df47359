"""Cross-pod gradient compression (port of ``repro/train/grad_compress.py``).

Within a pod, DP gradient reduction rides the fast links; *between* pods
it crosses the much slower inter-pod network. This module halves (bf16)
or quarters (int8 qsnap blocks) the inter-pod bytes.

Mechanism: every rank of the ``pod`` mesh dim computes the loss over its
pod's rows of the batch, and the pod mean of the gradients, the only
inter-pod transfer, is done explicitly on compressed payloads over the
``pod`` dim's process group:

    codes, scales = int8 blocks of grad       # 4x fewer bytes
    all = all_gather((codes, scales), pod)    # int8 (+1/256 f32)
    grad = mean(dequant(all))

Exact for equal-sized pod shards; quantization error bounded per
256-block by absmax/127/2. The arithmetic is plain PyTorch, as the
reference's is plain ``jnp``: scales are ``absmax / 127.0``, not the
qsnap codec's ``absmax * f32(1/127)`` (the two can part by one ULP), so
the qsnap kernel is not reused here.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.qsnap import QSNAP_BLOCK
from repro_torch.models.model import Model
from repro_torch.sharding.specs import dp_rows
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CODECS = ("none", "bf16", "int8")


def _gather(t: torch.Tensor, group: Any) -> torch.Tensor:
    """[n_pods, *t.shape]: every pod's ``t``, in group-rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def _int8_blocks(g: torch.Tensor):
    """-> (codes int8 [..., nb, 256], scales f32 [..., nb, 1], last): the
    last dim padded to a 256-block multiple (a 0-d grad is one element)."""
    x = g.float()
    if g.dim() == 0:
        x = x.reshape(1)
    last = x.shape[-1]
    pad = (-last) % QSNAP_BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], x.shape[-1] // QSNAP_BLOCK, QSNAP_BLOCK)
    scales = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(blocks / scales), -127, 127)
    return codes.to(torch.int8), scales, last


def payload_bytes(g: torch.Tensor, codec: str) -> int:
    """Bytes one pod sends for ``g`` under ``codec``."""
    if codec == "none":
        return g.numel() * g.element_size()
    if codec == "bf16":
        return g.numel() * 2
    last = g.shape[-1] if g.dim() else 1
    rows = g.numel() // last if last else 0
    nb = -(-last // QSNAP_BLOCK)
    return rows * nb * (QSNAP_BLOCK + 4)


def pod_mean_compressed(g: torch.Tensor, codec: str,
                        group: Any) -> torch.Tensor:
    """Mean of ``g`` over the ranks of ``group`` (the ``pod`` mesh dim)
    with compressed transfer.

    Quantization blocks run along the LAST dim only, as the reference's:
    leading-dim shardings survive and each rank moves its own tensor.
    """
    orig_dtype, orig_shape = g.dtype, g.shape
    if codec == "none":
        out = g.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)
    if codec == "bf16":
        h_all = _gather(g.to(torch.bfloat16), group)
        return h_all.float().mean(dim=0).to(orig_dtype)
    if codec != "int8":
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    codes, scales, last = _int8_blocks(g)
    codes_all = _gather(codes, group)                 # int8 across pods
    scales_all = _gather(scales, group)
    deq = codes_all.float() * scales_all
    out = deq.mean(dim=0)
    out = out.reshape(*out.shape[:-2], -1)[..., :last]
    return out.reshape(orig_shape).to(orig_dtype)


def make_compressed_train_step(model: Model, opt_cfg: AdamWConfig,
                               mesh: DeviceMesh, *, codec: str = "int8",
                               remat: Union[bool, str] = True):
    """Train step with compressed cross-pod gradient reduction.

    Requires a mesh with a ``pod`` dim; every rank calls the step with the
    same pod-replicated state (plain tensors) and the same global batch,
    and keeps the returned state pod-replicated. Each pod computes loss
    and grads on its rows of the batch, the grads cross the pods only
    through ``pod_mean_compressed``, the loss is pod-averaged, and
    ``adamw_update`` follows. Compute is replicated over any other mesh
    dim. Same (state, batch) -> (state, metrics) signature as
    ``trainer.make_train_step``.
    """
    if "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError("needs a mesh with a 'pod' dim")
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    group = mesh.get_group("pod")
    n_pods = mesh.size(mesh.mesh_dim_names.index("pod"))

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        lo, hi = dp_rows(batch["tokens"].shape[0], mesh, ("pod",))
        rows = {k: v[lo:hi] for k, v in batch.items()}
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with torch.enable_grad():
            loss, aux = model.loss(params, rows, remat=remat)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        grads = tree_unflatten(params, [pod_mean_compressed(g, codec, group)
                                        for g in grads])
        params, opt_state, om = adamw_update(
            opt_cfg, grads, state["opt_state"], state["params"])
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        metrics = {"loss": loss / n_pods,
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return ({"opt_state": opt_state, "params": params,
                 "step": state["step"] + 1}, metrics)

    return train_step
