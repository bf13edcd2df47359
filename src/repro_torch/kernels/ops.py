"""The model-layout wrappers around the attention kernels (port of the
attention half of ``repro/kernels/ops.py``; the qsnap half is
``kernels.qsnap``).

Layout follows the model code (``[B,S,H,hd]``); the wrappers hand the
kernels ``[B,H,S,hd]`` views and transpose the result back. ``impl``
selects the implementation:

  impl=None   the kernel's dispatcher: the CUDA kernel for a CUDA tensor,
              its plain version for a CPU tensor;
  impl="ref"  the f32 oracle of ``kernels.ref``, on any device.

The CUDA kernels mask the ragged edge themselves (``kv_len`` is their
contract), so unlike the TPU route nothing is padded to a block multiple.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import flash_attention_bhsd

IMPLS = (None, "ref")


def _check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,Hkv,hd] -> [B,S,H,hd]."""
    _check_impl(impl)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fn = ref.flash_attention_ref if impl == "ref" else flash_attention_bhsd
    return fn(qt, kt, vt, causal=causal, window=window).transpose(1, 2)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, impl: Optional[str] = None) -> torch.Tensor:
    """q: [B,1,H,hd]; k,v: [B,T,Hkv,hd]; slots 0..pos -> [B,1,H,hd]."""
    _check_impl(impl)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    fn = ref.decode_attention_ref if impl == "ref" else decode_attention_bhd
    return fn(q[:, 0], kt, vt, pos)[:, None]
