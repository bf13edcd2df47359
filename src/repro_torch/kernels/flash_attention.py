"""flash_attention — blocked GQA attention forward (prefill) on the card.

Port of ``repro/kernels/flash_attention.py``. ``flash_attention_bhsd_cuda``
is the hand-written CUDA kernel (``csrc/flash_attention.cu``, built by
``kernels.build``) that replaces ``_flash_kernel``;
``flash_attention_bhsd_plain`` is its plain PyTorch version (the f32
oracle ``ref.flash_attention_ref``). The dispatcher
``flash_attention_bhsd`` takes the plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises; for a ``meta`` tensor
(the launch tooling's trace) it returns the output's shape and records
the launch's FLOPs and bytes (``flash_attention_bhsd_meta``), never
forming the plain version's scores. ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through it.

The kernel reads its operands through their strides (the last dim must be
contiguous), so the ``[B,S,H,hd]`` -> ``[B,H,S,hd]`` transposes of
``kernels.ops`` stay views, and it masks the ragged edges itself
(``kv_len`` is its contract), so nothing is padded. bf16 operands run on
the tensor cores and are copied in 16-byte pieces: their bases must be
16-byte aligned and their (b, h, s) strides multiples of 8 elements
(``check_aligned``); f32 operands run on the CUDA cores. With
``return_lse`` the bf16 forward also writes each row's log-sum-exp (f32
[B,H,S]); the f32 kernel has no such output (f32 trains through
``attention_ref``).

The backward (``flash_attention_bwd_bhsd``; ``flash_attention_bwd_cuda``,
the same library's ``flash_attention_bwd``, and its plain version
``ref.flash_attention_bwd_ref``) replaces no TPU kernel: the TPU kernel
has no backward, and the reference trains through ``attention_ref``'s
autograd. It takes bf16 at head dims ``BWD_HEAD_DIMS``, what
``kernels.ops.flash_attention_train`` routes to it; ``LAUNCHES`` counts
its calls under ``flash_attention_bwd`` (one call, three kernels), and
the forwards launched with ``lse`` under ``flash_attention_lse``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check_launch, on_device

# a forward launched with ``lse`` (the train step's) counts under
# ``flash_attention_lse``, so ``flash_attention`` stays serving's count
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_lse": 0,
                            "flash_attention_bwd": 0}
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 96, 128, 256)
BWD_HEAD_DIMS = (64, 128)          # the backward: bf16 only


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p] + [i] * 11 + [
            ctypes.c_float, p, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_bwd.argtypes = [p] * 11 + [i] * 8 + [
            ctypes.c_float, p]
        lib.flash_attention_bwd.restype = i
        lib._typed = True
    return lib


def check_operands(what: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """What both attention kernels take: q [B,H,...,hd] against k, v
    [B,Hkv,T,hd] on one CUDA device, one dtype of ``DTYPES``, hd in
    ``HEAD_DIMS``, H a multiple of Hkv, the last dim contiguous. Runs on
    every launch, so it reads only what it must (ints, not objects)."""
    dt = q.dtype
    if dt not in DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"{what}: dtypes {q.dtype}, {k.dtype}, {v.dtype}"
                        f"; expected one of {DTYPES} for all three")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: the head dim must be contiguous")
    qs, ks = q.shape, k.shape
    hd = qs[-1]
    if len(ks) != 4 or ks != v.shape or ks[0] != qs[0] or ks[3] != hd:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if qs[1] % ks[1]:
        raise ValueError(f"{what}: {qs[1]} q-heads over {ks[1]} kv-heads")
    dev = q.get_device()                     # -1 on the CPU
    if dev < 0 or k.get_device() != dev or v.get_device() != dev:
        raise ValueError(f"{what}: operands must share one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")


def check_aligned(what: str, *ts: torch.Tensor) -> None:
    """The 16-byte copies of the kernels: each base 16-byte aligned, each
    stride but the last a multiple of 16 bytes. Refused, not worked
    around: the main path's views meet it."""
    for t in ts:
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % step for s in t.stride()[:-1]):
            raise ValueError(
                f"{what}: a {t.dtype} operand with base {t.data_ptr():#x} "
                f"and strides {t.stride()} is not 16-byte aligned")


def flash_attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: Optional[int] = None,
                               kv_len: Optional[int] = None,
                               scale: Optional[float] = None,
                               return_lse: bool = False):
    """q: [B,H,S,hd]; k,v: [B,Hkv,T,hd] -> [B,H,S,hd] (the f32 oracle);
    with ``return_lse``, (out, lse f32 [B,H,S])."""
    fn = ref.flash_attention_lse_ref if return_lse else ref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, kv_len=kv_len,
              scale=scale)


def flash_attention_bhsd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              kv_len: Optional[int] = None,
                              skip_masked_tiles: bool = True,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """The kernel: same contract as ``flash_attention_bhsd_plain``. The
    scale goes to the kernel as an f32 argument; by default (None) the
    kernel forms 1/sqrt(hd) itself, as it always has. ``return_lse``
    (bf16 only) hands the kernel an f32 [B,H,S] buffer for the rows'
    log-sum-exp; without it the kernel gets a null pointer and writes what
    it did before the output existed.

    Keys at or past ``kv_len`` (default T) are masked and never read. The
    output has q's layout. ``skip_masked_tiles=False`` makes the kernel
    visit the k/v tiles wholly outside the causal/window band instead of
    skipping them, which must give the same bits (a check, not a mode).
    """
    check_operands("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B,H,S,hd], got "
                         f"{tuple(q.shape)}")
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    kv_len = T if kv_len is None else int(kv_len)
    if not 0 < kv_len <= T:
        raise ValueError(f"flash_attention: kv_len {kv_len} not in [1, {T}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} <= 0")
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: return_lse takes bf16, not "
                         f"{q.dtype}")
    out = torch.empty_like(q)          # keeps q's strides (a dense view)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", q, k, v, out)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    with on_device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, int(q.dtype == torch.bfloat16), B, H, S, Hkv, T, hd,
            kv_len, int(causal), -1 if window is None else int(window),
            int(skip_masked_tiles), 0.0 if scale is None else float(scale),
            None if lse is None else lse.data_ptr(),
            build.current_stream(q.get_device()))
    check_launch(err, "flash_attention")
    LAUNCHES["flash_attention_lse" if return_lse else "flash_attention"] += 1
    return (out, lse) if return_lse else out


def visible_pairs(S: int, T: int, *, causal: bool = True,
                  window: Optional[int] = None,
                  kv_len: Optional[int] = None) -> int:
    """How many (query, key) pairs of one head the mask leaves visible:
    query row i sees key j < ``kv_len`` with j <= i (causal) and
    i - j < ``window``."""
    kv_len = T if kv_len is None else kv_len
    if not causal:
        return S * kv_len
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(np.minimum(i, kv_len - 1) - lo + 1, 0).sum())


def flash_attention_bhsd_meta(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              kv_len: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's route on ``meta`` tensors: the output's shape alone,
    and the launch's FLOPs (4 a visible pair a head and head-dim element)
    and HBM bytes (q, the keys and values up to ``kv_len``, the output)
    recorded in ``build.META_CALLS``."""
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    kv = T if kv_len is None else int(kv_len)
    pairs = visible_pairs(S, T, causal=causal, window=window, kv_len=kv)
    build.record_meta("flash_attention", 4 * B * H * hd * pairs,
                      q.element_size() * (2 * q.numel() + 2 * B * Hkv * kv
                                          * hd))
    return torch.empty_like(q)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         kv_len: Optional[int] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: [B,H,S,hd]; k,v: [B,Hkv,T,hd] -> [B,H,S,hd]; scores scaled by
    ``scale`` (default 1/sqrt(hd)). With ``return_lse`` (not on
    ``meta``): (out, lse f32 [B,H,S])."""
    kw = dict(causal=causal, window=window, kv_len=kv_len, scale=scale)
    if q.device.type == "meta":
        return flash_attention_bhsd_meta(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, return_lse=return_lse,
                                          **kw)
    return flash_attention_bhsd_cuda(q, k, v, return_lse=return_lse, **kw)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward kernel: q, o, do [B,H,S,hd] and k, v [B,Hkv,T,hd],
    bf16, hd in ``BWD_HEAD_DIMS``, read through their strides; lse f32
    [B,H,S] contiguous, the forward's. Returns (dq, dk, dv) with the
    strides of q, k, v (``empty_like``), so the transposed views of a
    [B,S,H,hd] layout get gradients in that layout."""
    check_operands("flash_attention_bwd", q, k, v)
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or hd not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: {q.dtype} at head dim {hd}"
                         f"; the kernel takes bf16 at {BWD_HEAD_DIMS}")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or o.stride(-1) != 1 \
            or do.stride(-1) != 1:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must be q's shape and dtype, hd contiguous")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be f32 [B,H,S], contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window {window} < 1")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_attention_bwd: scale {scale} <= 0")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty_like(lse)                 # D = rowsum(do o), f32
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    check_aligned("flash_attention_bwd", q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    lib = _lib()
    with on_device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, B, H, S, Hkv, T, hd,
            int(causal), -1 if window is None else int(window),
            0.0 if scale is None else float(scale),
            build.current_stream(q.get_device()))
    check_launch(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd_bhsd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """The backward of ``flash_attention_bhsd(..., return_lse=True)``:
    (dq, dk, dv). The plain version for a CPU tensor; for any other the
    kernel, which raises where it cannot run (no fallback)."""
    kw = dict(causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    return flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
