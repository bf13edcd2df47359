#!/usr/bin/env python3
"""Time the port's qsnap kernels on one GPU.

Times ``qsnap_quantize_cuda`` and ``qsnap_dequantize_cuda`` of the
checkout this script sits in (``src/repro_torch``) over the float leaves
of the repro-100m train state (random init, seed 0: 33 leaves,
386,982,144 elements), on its largest leaf (28,311,552 f32) and, for
dequantize, on its largest bf16 leaf. Each is timed two ways: eager, one
call between two CUDA events (host work included, median of ``--reps``);
and device, the call captured in a CUDA graph and replayed ``--reps``
times between two events. Beside them: the memory bound (each input read
once, each output written once, at the card's data-sheet rate) and one
``torch.Tensor.copy_`` moving the same bytes as one dequantize launch
(the card's reachable copy rate, a yardstick of bandwidth; no PyTorch
call computes dequantize).

It uses only the wrappers' public entry points, so it runs unchanged
from an older checkout of the port. To compare two commits on one card,
copy it into the other checkout's ``scripts/`` and run it from each
checkout in turns, back to back (old, new, new, old):

    python3 scripts/qsnap_times.py [--reps 100]

Prints one JSON object, with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

from attention_times import device_ms, eager_ms

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MEM_RATE = 3.35e12        # H100 SXM, bytes/s (data sheet)


def moved(n: int, out_size: int) -> int:
    """Bytes one launch must move for n elements: the codes, a scale per
    256, and n values of ``out_size`` bytes."""
    return n * (1 + out_size) + 4 * (n // 256)


def qsnap_times(torch, dev, reps):
    from repro_torch.configs import get_config
    from repro_torch.kernels import qsnap
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import init_state
    from repro_torch.tree import tree_leaves
    leaves = [t.reshape(-1) for t in tree_leaves(init_state(
        build_model(get_config("repro-100m")), 0, dev))
        if t.is_floating_point()]
    encoded = [qsnap.qsnap_quantize_cuda(t) for t in leaves]
    big = max(leaves, key=lambda t: t.numel() * t.element_size())
    big16 = max((t for t in leaves if t.dtype == torch.bfloat16),
                key=torch.Tensor.numel)
    cases = {
        "quantize_leaves": (lambda: [qsnap.qsnap_quantize_cuda(t)
                                     for t in leaves],
                            sum(moved(t.numel(), t.element_size())
                                for t in leaves)),
        "dequantize_leaves": (lambda: [qsnap.qsnap_dequantize_cuda(
            c, s, t.dtype) for t, (c, s) in zip(leaves, encoded)],
            sum(moved(t.numel(), t.element_size()) for t in leaves)),
        "quantize_largest": (lambda: qsnap.qsnap_quantize_cuda(big),
                             moved(big.numel(), big.element_size())),
    }
    for what, t in (("largest", big), ("largest_bf16", big16)):
        c, s = qsnap.qsnap_quantize_cuda(t)
        cases[f"dequantize_{what}"] = (
            lambda c=c, s=s, dt=t.dtype: qsnap.qsnap_dequantize_cuda(c, s, dt),
            moved(t.numel(), t.element_size()))
    out = {}
    for name, (fn, nbytes) in cases.items():
        out[name] = {"ms": eager_ms(torch, fn, reps),
                     "device_ms": device_ms(torch, fn, reps),
                     "bound_ms": nbytes / MEM_RATE * 1e3, "bytes": nbytes}
    for name in ("dequantize_largest", "dequantize_largest_bf16"):
        src = torch.empty(out[name]["bytes"] // 2, dtype=torch.uint8,
                          device=dev)
        dst = torch.empty_like(src)
        out[name]["copy_device_ms"] = device_ms(
            torch, lambda: dst.copy_(src), reps)
        del src, dst
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("qsnap_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({
        "tree": str(ROOT), "card": smi.stdout.strip().splitlines()[0]
        if smi.returncode == 0 else torch.cuda.get_device_name(0),
        "times": qsnap_times(torch, dev, args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
