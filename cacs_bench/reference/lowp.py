"""Matmuls at the precision a reference is asked to run in.

``"f32"``: float32 with TF32 off (the judge). ``"fp8"``: both operands
rounded to float8 e4m3 with one scale a tensor before a float32 product,
the precision below bfloat16 that a control is computed in.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def set_exact_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to e4m3 under one per-tensor scale; back in float32.
    The gradient passes the rounding unchanged, as an fp8 matmul's
    backward takes it."""
    xd = x.detach()
    s = xd.abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (xd / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - xd) if x.requires_grad else q


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp8":
        a, b = to_fp8(a), to_fp8(b)
    elif mode != "f32":
        raise ValueError(f"unknown precision {mode!r}")
    return a @ b
