"""Checkpoint image codecs (paper Table 2: image size is the scaling lever).

Codecs operate on raw little-endian chunk bytes:
  * ``raw``       — identity.
  * ``zlib``      — lossless deflate (cheap CPU, good on low-entropy state).
  * ``int8``      — blockwise absmax int8 quantization of float leaves
                    (lossy; used for *swap-out* images of preempted jobs and
                    for gradient compression — not for exact restarts).
  * ``int8+zlib`` — both.

The int8 codec's math mirrors ``repro_torch.kernels.ref.qsnap_ref`` exactly — the
CUDA kernel (device-side compression before D2H copy) and this host codec
are interchangeable, and tests assert bit-identical round-trips between them.

Port of ``repro/ckpt/compression.py`` without ``ml_dtypes``: bf16 is
recognised by its dtype name (``"bfloat16"``, which is also what
``str(np.dtype(ml_dtypes.bfloat16))`` gives), its bytes are read as 16-bit
words and widened to f32 exactly, and the int8 decode rounds f32 to bf16
to nearest even, as ``.to(torch.bfloat16)`` and ``ml_dtypes`` do.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

BLOCK = 256
_MAGIC = b"QS01"

# Scales are computed as absmax * (1/127) — an IEEE f32 multiply — rather
# than absmax / 127.  XLA rewrites division by a constant into a
# reciprocal multiply, so the multiply formulation is the only one that is
# bit-identical between this host codec, the jnp oracle, and the Pallas
# kernel (device-side encode).  Interchange tests depend on this.
INV127 = np.float32(1.0 / 127.0)

BF16 = "bfloat16"


def is_bf16(dt) -> bool:
    """True for the bf16 dtype, given by name or as a numpy dtype."""
    return str(dt) == BF16


def is_float_dtype(dt) -> bool:
    """Quantizable-float predicate shared with the device encode path.

    Host and device encoders must agree on which leaves quantize, or the
    same pytree produces different images on the two paths.  bf16 is the
    training dtype and must count even though numpy has no such dtype.
    """
    return is_bf16(dt) or np.dtype(dt).kind == "f"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 words (any 16-bit integer dtype) -> f32, exactly."""
    return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 words (uint16), rounding to nearest even; a NaN becomes
    the quiet NaN of its sign, as ``ml_dtypes`` gives it."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    out[nan] = np.where(np.signbit(x[nan]), 0xFFC0, 0x7FC0)
    return out


def quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x: float array -> (int8 codes [n_pad], f32 scales [n_blocks])."""
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    n = flat.size
    n_pad = ((n + BLOCK - 1) // BLOCK) * BLOCK
    buf = np.zeros(n_pad, np.float32)
    buf[:n] = flat
    blocks = buf.reshape(-1, BLOCK)
    scales = np.max(np.abs(blocks), axis=1) * INV127
    scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
    codes = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
    return codes.reshape(-1), scales


def dequantize_int8(codes: np.ndarray, scales: np.ndarray,
                    n: int) -> np.ndarray:
    blocks = codes.reshape(-1, BLOCK).astype(np.float32) * scales[:, None]
    return blocks.reshape(-1)[:n]


def frame_int8(n: int, scales: np.ndarray, codes: np.ndarray) -> bytes:
    """Frame (codes, scales) of an n-element float chunk as a QS01 payload.

    Shared by the host codec and the device encode path
    (``repro_torch.kernels.qsnap.qsnap_encode_chunks``) so both emit the exact
    same bytes — CAS digests over encoded bytes then dedup across the two.
    """
    return (_MAGIC + b"INT8"
            + struct.pack("<qq", n, scales.size)
            + scales.tobytes() + codes.tobytes())


def frame_raw(data: bytes) -> bytes:
    """Frame a non-float chunk's raw bytes as a QS01 passthrough payload."""
    return _MAGIC + b"RAWD" + data


def encode(data: bytes, dtype: np.dtype, codec: str) -> bytes:
    """Encode one chunk's raw bytes."""
    if codec == "raw":
        return data
    if codec == "zlib":
        return zlib.compress(data, level=1)
    if codec in ("int8", "int8+zlib"):
        if not is_float_dtype(dtype):
            payload = frame_raw(data)             # non-float: store raw
        else:
            if is_bf16(dtype):
                arr = bf16_bits_to_f32(np.frombuffer(data, np.uint16))
            else:
                arr = np.frombuffer(data, dtype=np.dtype(dtype))
            codes, scales = quantize_int8(arr.astype(np.float32))
            payload = frame_int8(arr.size, scales, codes)
        if codec == "int8+zlib":
            return zlib.compress(payload, level=1)
        return payload
    raise ValueError(f"unknown codec {codec!r}")


def parse_int8(data: bytes) -> Tuple[int, np.ndarray, np.ndarray]:
    """Unframe a ``QS01INT8`` payload -> (n, scales f32, codes int8)."""
    n, n_scales = struct.unpack("<qq", data[8:24])
    off = 24 + 4 * n_scales
    return (n, np.frombuffer(data[24:off], np.float32),
            np.frombuffer(data[off:], np.int8))


def decode(data: bytes, dtype: np.dtype, codec: str) -> bytes:
    if codec == "raw":
        return data
    if codec == "zlib":
        return zlib.decompress(data)
    if codec in ("int8", "int8+zlib"):
        if codec == "int8+zlib":
            data = zlib.decompress(data)
        assert data[:4] == _MAGIC, "corrupt int8 chunk"
        kind = data[4:8]
        if kind == b"RAWD":
            return data[8:]
        n, scales, codes = parse_int8(data)
        out = dequantize_int8(codes, scales, n)
        if is_bf16(dtype):
            return f32_to_bf16_bits(out).tobytes()
        return out.astype(np.dtype(dtype)).tobytes()
    raise ValueError(f"unknown codec {codec!r}")
