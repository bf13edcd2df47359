"""decode_attention — one query token over a KV cache, GQA, on the card.

Port of ``repro/kernels/decode_attention.py``.
``decode_attention_bhd_cuda`` is the hand-written CUDA kernel
(``csrc/decode_attention.cu``, built by ``kernels.build``) that replaces
``_decode_kernel``; ``decode_attention_bhd_plain`` is its plain PyTorch
version (the f32 oracle ``ref.decode_attention_ref``). The dispatcher
``decode_attention_bhd`` takes the plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts
calls that launched the kernel (one per call, though the kernel runs as
two CUDA launches: the chunks of the cache, then their combine).

``pos`` is a host integer handed to the kernel as an argument: no step
builds anything anew. Slots past ``pos`` are never read. Like the TPU
kernel, this one has no sliding window.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check_launch, on_device
from repro_torch.kernels.flash_attention import check_operands

LAUNCHES: Dict[str, int] = {"decode_attention": 0}


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p] + [i] * 6 \
            + [p, p, p, p]
        lib.decode_attention_fwd.restype = i
        lib.decode_attention_chunk.argtypes = []
        lib.decode_attention_chunk.restype = i
        lib._typed = True
    return lib


def decode_attention_bhd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos) -> torch.Tensor:
    """q: [B,H,hd]; k,v: [B,Hkv,T,hd]; slots 0..pos -> [B,H,hd]."""
    return ref.decode_attention_ref(q, k, v, pos)


def decode_attention_bhd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pos) -> torch.Tensor:
    """The kernel: same contract as ``decode_attention_bhd_plain``; the
    output has q's layout."""
    check_operands("decode_attention", q, k, v)
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be [B,H,hd], got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    pos = int(pos)
    if not 0 <= pos < T:
        raise ValueError(f"decode_attention: pos {pos} outside the cache "
                         f"[0, {T})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    n_chunks = pos // lib.decode_attention_chunk() + 1
    part_m = torch.empty((B * Hkv * n_chunks * (H // Hkv),),
                         dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((part_m.numel() * hd,), dtype=torch.float32,
                           device=q.device)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2])
    with on_device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, int(q.dtype == torch.bfloat16), B, H, Hkv, hd, pos,
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_bhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos) -> torch.Tensor:
    """q: [B,H,hd]; k,v: [B,Hkv,T,hd]; slots 0..pos -> [B,H,hd]."""
    if q.device.type == "cpu":
        return decode_attention_bhd_plain(q, k, v, pos)
    return decode_attention_bhd_cuda(q, k, v, pos)
