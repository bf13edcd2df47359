"""Blockwise absmax quantization round trip, as the image format states it.

Each block of 256 values keeps one float32 scale, ``absmax * fl32(1/q)``
(1 where the block is all zero), and codes ``round(x / scale)`` clamped to
``[-q, q]``, ``q = 2**(bits-1) - 1``: 127 for int8; 7 for the int4
control. Dequantized values are ``code * scale`` in float32, cast to the
leaf's dtype.
"""
from __future__ import annotations

import torch

BLOCK = 256


def roundtrip(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    q = 2 ** (bits - 1) - 1
    flat = x.detach().reshape(-1).float()
    n = flat.numel()
    pad = (-n) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, BLOCK)
    inv = torch.tensor(1.0 / q, dtype=torch.float32, device=x.device)
    scales = blocks.abs().amax(dim=1) * inv
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -q, q)
    out = (codes * scales[:, None]).reshape(-1)[:n]
    return out.view(x.shape).to(x.dtype)


def gap_in_codes(restored: torch.Tensor, captured: torch.Tensor,
                 bits: int = 8) -> float:
    """Largest |restored - roundtrip(captured)| over the leaf, in units of
    each block's int8 scale (one code step reads 1.0)."""
    want = roundtrip(captured, bits).float().reshape(-1)
    got = restored.detach().float().reshape(-1)
    n = got.numel()
    pad = (-n) % BLOCK
    ref = captured.detach().float().reshape(-1)
    if pad:
        ref = torch.nn.functional.pad(ref, (0, pad))
        want = torch.nn.functional.pad(want, (0, pad))
        got = torch.nn.functional.pad(got, (0, pad))
    scale8 = ref.view(-1, BLOCK).abs().amax(dim=1) / 127.0
    scale8 = torch.where(scale8 == 0, torch.ones_like(scale8), scale8)
    gap = (got - want).abs().view(-1, BLOCK) / scale8[:, None]
    return float(gap.max()) if gap.numel() else 0.0
