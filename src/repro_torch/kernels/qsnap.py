"""qsnap — blockwise int8 quantization of checkpoint images on the card.

Port of ``repro/kernels/qsnap.py``. Each 256-element block stores one f32
absmax scale + 256 int8 codes — the exact format
``repro_torch.ckpt.compression`` writes, so device- and host-compressed
images are interchangeable, with the JAX package's too.

Kernels (CUDA C++, ``csrc/qsnap.cu``, built by ``kernels.build``):
  * ``qsnap_quantize_cuda``   replaces ``_quant_kernel``;
  * ``qsnap_dequantize_cuda`` replaces ``_dequant_kernel``.
Beside each sits its plain PyTorch version (``*_plain``), the same
arithmetic in torch ops. The dispatchers ``qsnap_quantize`` and
``qsnap_dequantize`` take the plain version only for a CPU tensor; for a
CUDA tensor they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through them.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.ckpt import compression
from repro_torch.ckpt.layout import dtype_name, host_array
from repro_torch.kernels import ref
from repro_torch.obs.trace import tracer

QSNAP_BLOCK = 256
LAUNCHES: Dict[str, int] = {"quantize": 0, "dequantize": 0}
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _padded(n: int) -> int:
    return -(-n // QSNAP_BLOCK) * QSNAP_BLOCK


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("qsnap")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qsnap_quantize.argtypes = [p, i, ll, p, p, p]
        lib.qsnap_quantize.restype = i
        lib.qsnap_dequantize.argtypes = [p, p, ll, p, i, p]
        lib.qsnap_dequantize.restype = i
        lib._typed = True
    return lib


def _check(t: torch.Tensor, what: str, dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)}")


def _on(device: torch.device):
    """Make ``device`` current for a launch (a no-op when it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def qsnap_quantize_plain(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [N] float, any N -> (codes int8 [N_pad], scales f32 [N_pad/256]),
    N_pad = ceil(N/256)*256; the tail is zero padding."""
    xf = x.reshape(-1).float()
    pad = _padded(xf.numel()) - xf.numel()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    return ref.qsnap_ref(xf)


def qsnap_quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: same contract as ``qsnap_quantize_plain``, f32 or bf16 in."""
    _check(x, "qsnap_quantize", _OUT_DTYPES)
    n = x.numel()
    codes = torch.empty(_padded(n), dtype=torch.int8, device=x.device)
    scales = torch.empty(_padded(n) // QSNAP_BLOCK, dtype=torch.float32,
                         device=x.device)
    if n == 0:
        return codes, scales
    lib = _lib()
    with _on(x.device):
        err = lib.qsnap_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), n, codes.data_ptr(),
            scales.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "qsnap_quantize")
    LAUNCHES["quantize"] += 1
    return codes, scales


def qsnap_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return qsnap_quantize_plain(x)
    return qsnap_quantize_cuda(x)


# ---------------------------------------------------------------------------
# dequantize
# ---------------------------------------------------------------------------

def qsnap_dequantize_plain(codes: torch.Tensor, scales: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """Inverse of qsnap_quantize -> [N_pad] of ``dtype``."""
    return ref.qsnap_dequant_ref(codes, scales, dtype)


def qsnap_dequantize_cuda(codes: torch.Tensor, scales: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """The kernel: f32 or bf16 (round to nearest even) out."""
    _check(codes, "qsnap_dequantize codes", (torch.int8,))
    _check(scales, "qsnap_dequantize scales", (torch.float32,))
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"qsnap_dequantize: out dtype {dtype} not in "
                        f"{_OUT_DTYPES}")
    n = codes.numel()
    if n % QSNAP_BLOCK or scales.numel() != n // QSNAP_BLOCK \
            or scales.device != codes.device:
        raise ValueError(f"qsnap_dequantize: {n} codes do not match "
                         f"{scales.numel()} scales on {scales.device}")
    out = torch.empty(n, dtype=dtype, device=codes.device)
    if n == 0:
        return out
    lib = _lib()
    with _on(codes.device):
        err = lib.qsnap_dequantize(
            codes.data_ptr(), scales.data_ptr(), n, out.data_ptr(),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "qsnap_dequantize")
    LAUNCHES["dequantize"] += 1
    return out


def qsnap_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    if codes.device.type == "cpu":
        return qsnap_dequantize_plain(codes, scales, dtype)
    return qsnap_dequantize_cuda(codes, scales, dtype)


# ---------------------------------------------------------------------------
# snapshot encode
# ---------------------------------------------------------------------------

def _host_buffer(t: torch.Tensor) -> torch.Tensor:
    """A host tensor to copy ``t`` into: pinned when ``t`` is on a card,
    so the copy runs asynchronously."""
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")


def qsnap_encode_chunks(tensors: Sequence[torch.Tensor]) -> List[bytes]:
    """Quantize whole-leaf tensors on their device into ``QS01`` payloads.

    For each float tensor this runs the blockwise int8 quantization where
    the tensor lives (the CUDA kernel on a card, the plain version on the
    CPU) and frames the result exactly as
    ``repro_torch.ckpt.compression.encode(..., "int8")`` would: the
    device→host copy carries int8 codes + one f32 scale per 256 elements
    (~4x fewer bytes than f32 state), and the payload is byte-identical to
    the host codec's, so CAS digests over encoded bytes dedup across
    device- and host-compressed images.

    Non-float tensors fall back to the host RAWD framing (they are small:
    step counters). All device work is issued first, then every
    codes/scales pair is copied into pinned host buffers without blocking,
    then one synchronize, then framing. Each of the three phases is a
    span (``qsnap/quantize``: the launches issued; ``qsnap/d2h``: the
    copies issued and the synchronize, so it holds the kernels' device
    time too; ``qsnap/frame``: host framing).
    """
    tr = tracer()
    payloads: List[bytes] = [b""] * len(tensors)
    staged = []                      # (index, n, device codes, scales)
    with tr.span("qsnap/quantize", cat="ckpt"):
        for i, t in enumerate(tensors):
            if not compression.is_float_dtype(dtype_name(t.dtype)):
                payloads[i] = compression.frame_raw(host_array(t).tobytes())
                continue
            flat = t.detach().reshape(-1)
            if flat.dtype not in _OUT_DTYPES:
                flat = flat.float()  # f16/f64: widen or round like numpy
            codes, scales = qsnap_quantize(flat.contiguous())
            staged.append((i, flat.numel(), codes, scales))
    fetched = []
    with tr.span("qsnap/d2h", cat="ckpt"):
        for i, n, codes, scales in staged:
            hc, hs = _host_buffer(codes), _host_buffer(scales)
            hc.copy_(codes, non_blocking=True)
            hs.copy_(scales, non_blocking=True)
            fetched.append((i, n, hc, hs))
        if any(c.device.type == "cuda" for _, _, c, _ in staged):
            torch.cuda.synchronize()
    with tr.span("qsnap/frame", cat="ckpt"):
        for i, n, hc, hs in fetched:
            payloads[i] = compression.frame_int8(n, hs.numpy(), hc.numpy())
    return payloads
