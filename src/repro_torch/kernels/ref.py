"""Plain-torch oracles for the qsnap kernels (port of the qsnap part of
``repro/kernels/ref.py``; the attention oracles come with their kernels).
"""
from __future__ import annotations

from typing import Tuple

import torch

QSNAP_BLOCK = 256


def qsnap_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int8 quantization. x: [N] (N % 256 == 0).

    Returns (codes int8 [N], scales f32 [N/256]). Matches
    ``repro_torch.ckpt.compression.quantize_int8`` bit-for-bit (both sides
    use the absmax * f32(1/127) multiply — see ``compression.INV127``).
    """
    xf = x.float().reshape(-1, QSNAP_BLOCK)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scales = xf.abs().amax(dim=1) * inv127
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(xf / scales[:, None]), -127, 127)
    return codes.to(torch.int8).reshape(-1), scales


def qsnap_dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    blocks = codes.reshape(-1, QSNAP_BLOCK).float()
    return (blocks * scales[:, None]).reshape(-1).to(dtype)
