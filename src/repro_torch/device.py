"""Device selection for the port's entry points.

``TrainerApp``, ``ckpt.restore``, ``train.init_state``, ``Model.init``
and the ``convert`` functions run on ``cuda`` unless the caller asks for
the CPU. With no GPU and no explicit CPU request they raise: the
port never carries on quietly on the CPU.

The first time a CUDA device is chosen, ``resolve_device`` makes the
card's numbers reproducible, which the bit-exact resume contract needs
(a run restored from a lossless image replays the uninterrupted run's
losses exactly): a fixed cuBLAS workspace, deterministic algorithms (the
embedding backward then takes its deterministic ``index_add``), and
full-f32 matrix products and convolutions (no TF32). Uninitialized
memory is left as it is (deterministic mode would NaN-fill it).
"""
from __future__ import annotations

import os
from typing import Any

import torch

_deterministic = False


def make_cuda_deterministic() -> None:
    """Set the process-wide switches for reproducible CUDA numerics.

    Must run before the first cuBLAS call of the process: cuBLAS reads
    ``CUBLAS_WORKSPACE_CONFIG`` when it creates its handle.
    """
    global _deterministic
    if _deterministic:
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # deterministic mode also NaN-fills every torch.empty by default: a
    # debugging aid that costs a memset per allocation and changes no
    # value a correct program reads
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _deterministic = True


def resolve_device(device: Any = None) -> torch.device:
    """``None`` -> the current CUDA device; raise when there is none.

    An explicit ``"cpu"`` (or ``torch.device("cpu")``) runs on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but CUDA is not "
                               f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        make_cuda_deterministic()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
