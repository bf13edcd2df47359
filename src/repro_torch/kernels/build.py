"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes;
the helpers every kernel wrapper uses around a launch, and the record of
the calls a kernel wrapper takes on ``meta`` tensors.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled into
its own shared library under ``src/repro_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source and ``NVCC_FLAGS``, so a
changed source rebuilds and an unchanged one loads as it is. The flags
are fixed: the kernels' bit-identity with the host codec needs
``--fmad=false`` and no fast math. Building happens at first use, never
at import: the CPU tests import every module on a machine with no
``nvcc``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler's output."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        str(CSRC / f"{name}.cu")],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{p.stdout}")
    os.replace(tmp, out)                     # atomic: no half-built .so
    return p.stdout


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def on_device(device: torch.device):
    """Make ``device`` current for a launch (a no-op when it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device_index: int) -> int:
    """The handle of PyTorch's current stream on a device, the launches'
    stream: what ``torch.cuda.current_stream(i).cuda_stream`` gives,
    without building a Stream object (0.2 us a call against 8 us on an
    H100 machine's host; the wrappers ask on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_launch(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# kernel calls on ``meta`` tensors (a shape-only trace, where nothing is
# launched): per kernel, [calls, FLOPs, HBM bytes] of the launches the
# card would make; the launch tooling reads and resets it
META_CALLS: Dict[str, List[int]] = {}


def record_meta(name: str, flops: int, n_bytes: int) -> None:
    """Count one ``meta`` call of kernel ``name`` with the operations and
    the bytes its launch would do (each input read once, each output
    written once)."""
    c = META_CALLS.setdefault(name, [0, 0, 0])
    c[0] += 1
    c[1] += int(flops)
    c[2] += int(n_bytes)
