"""The public wrappers around the kernels (port of
``repro/kernels/ops.py``): the attention kernels in the model's layout,
and qsnap over a float tensor of any shape.

Attention layout follows the model code (``[B,S,H,hd]``); the wrappers
hand the kernels ``[B,H,S,hd]`` views and transpose the result back.
``qsnap_compress`` flattens and zero-pads to ``QSNAP_BLOCK`` and returns
``(codes, scales, n_orig)``; ``qsnap_decompress`` inverts it to a shape
and dtype. ``impl`` selects the implementation:

  impl=None   the kernel's dispatcher: the CUDA kernel for a CUDA tensor,
              its plain version for a CPU tensor; for a ``meta`` tensor
              (the launch tooling's trace) the output's shape, with the
              launch's FLOPs and bytes recorded in ``build.META_CALLS``;
  impl="ref"  the f32 oracle of ``kernels.ref``, on any device.

The CUDA attention kernels mask the ragged edge themselves (``kv_len``
is their contract), so unlike the TPU route nothing is padded to a block
multiple.

``flash_attention_train`` is the flash forward with its hand-written
backward as one autograd function (the train step's self-attention on the
card; its plain versions on the CPU).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS,
                                                 flash_attention_bhsd,
                                                 flash_attention_bwd_bhsd)
from repro_torch.kernels.qsnap import qsnap_dequantize, qsnap_quantize

IMPLS = (None, "ref")
QSNAP_BLOCK = ref.QSNAP_BLOCK


def _check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: Optional[str] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,Hkv,hd] -> [B,S,H,hd]; scores scaled by
    ``scale`` (default 1/sqrt(hd))."""
    _check_impl(impl)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fn = ref.flash_attention_ref if impl == "ref" else flash_attention_bhsd
    return fn(qt, kt, vt, causal=causal, window=window,
              scale=scale).transpose(1, 2)


class _FlashTrain(torch.autograd.Function):
    """The flash forward (with ``lse``) and its backward kernel. Saves q,
    k, v, the output and ``lse``: no scores. In the [B,S,H,hd] layout;
    the kernels read and write its transposed views through their
    strides, so nothing is copied."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_bhsd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale, return_lse=True)
        o = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()        # the kernel's 16-byte reads
        dq, dk, dv = flash_attention_bwd_bhsd(
            *(t.transpose(1, 2) for t in (q, k, v, o, do)), lse, **ctx.kw)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None)


def flash_trains(q: torch.Tensor) -> bool:
    """Whether ``flash_attention_train`` runs the kernels on ``q``: a CUDA
    tensor in bf16 at a head dim of ``BWD_HEAD_DIMS``."""
    return (q.is_cuda and q.dtype == torch.bfloat16
            and q.shape[-1] in BWD_HEAD_DIMS)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention: q [B,S,H,hd]; k,v [B,T,Hkv,hd] ->
    [B,S,H,hd], query row i seeing key j by index (``positions`` are
    ``arange``). The forward kernel with ``lse`` and the backward kernel
    on a CUDA tensor (bf16, hd 64 or 128: ``flash_trains``; anything else
    there raises), their plain versions on the CPU."""
    return _FlashTrain.apply(q, k, v, causal, window, scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, impl: Optional[str] = None,
                     return_lse: bool = False,
                     scale: Optional[float] = None):
    """q: [B,1,H,hd]; k,v: [B,T,Hkv,hd]; slots 0..pos -> [B,1,H,hd],
    scores scaled by ``scale`` (default 1/sqrt(hd)). With
    ``return_lse``: (out, lse f32 [B,1,H]), the log-sum-exp of each head's
    scaled scores over those slots, which the kernel writes beside its
    output; ``pos = -1`` (an empty slice) gives zeros and -inf."""
    _check_impl(impl)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if return_lse:
        fn = (ref.decode_attention_lse_ref if impl == "ref" else
              lambda *a, **kw: decode_attention_bhd(*a, return_lse=True,
                                                    **kw))
        out, lse = fn(q[:, 0], kt, vt, pos, scale=scale)
        return out[:, None], lse[:, None]
    fn = ref.decode_attention_ref if impl == "ref" else decode_attention_bhd
    return fn(q[:, 0], kt, vt, pos, scale=scale)[:, None]


def qsnap_compress(x: torch.Tensor, *, impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Any-shape float tensor -> (codes int8 [Npad], scales f32
    [Npad/256], n_orig): flattened, zero-padded to a multiple of
    ``QSNAP_BLOCK``, quantized where it lives (f16 and f64 are widened or
    rounded to f32 first, as the host codec does)."""
    _check_impl(impl)
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % QSNAP_BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    if impl == "ref":
        codes, scales = ref.qsnap_ref(flat)
    else:
        if flat.dtype not in (torch.float32, torch.bfloat16):
            flat = flat.float()
        codes, scales = qsnap_quantize(flat.contiguous())
    return codes, scales, n


def qsnap_decompress(codes: torch.Tensor, scales: torch.Tensor, n: int,
                     shape: Sequence[int], dtype=torch.float32, *,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Inverse of ``qsnap_compress``: the first ``n`` values, of
    ``dtype`` (f32 or bf16), in ``shape``."""
    _check_impl(impl)
    if impl == "ref":
        flat = ref.qsnap_dequant_ref(codes, scales, dtype)
    else:
        flat = qsnap_dequantize(codes, scales, dtype)
    return flat[:n].reshape(tuple(shape))
