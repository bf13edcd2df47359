#!/usr/bin/env python3
"""Time the port's attention kernels, and serving, on one GPU.

Times ``flash_attention_bhsd_cuda`` and ``decode_attention_bhd_cuda`` of
``src/repro_torch`` at the served shapes of repro-100m (flash q
[8,12,512,64] against k/v [8,4,512,64]; decode q [8,12,64] against a
cache [8,4,640,64] at pos 639) and one long case each (flash S = T =
4096, B = 2; decode T = 32768, B = 8), all bf16, beside
``scaled_dot_product_attention`` (the yardstick; the port never calls
it). Each is timed two ways: eager, one call between two CUDA events
(host work included, median of ``--reps``); and device, the call
captured in a CUDA graph and replayed ``--reps`` times between two
events; beside each, the names of the device kernels one call launches
(which of PyTorch's kernels sdpa picked). With ``--serve`` it also
times ``Engine.prefill`` and ``Engine.decode`` of repro-100m (batch 8,
prompt 512), random weights from seed 0, each step ended by a
synchronize.

It uses only the wrappers' public entry points, so it runs unchanged
from an older checkout of the port. To compare two commits on one card,
run it from each checkout in turns, back to back (old, new, new, old):

    python3 scripts/attention_times.py [--reps 100] [--serve]
        [--plan-blocks 1024 2048 4096]

Prints one JSON object, with the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def eager_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_kernels(torch, fn):
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:90] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def kernel_times(torch, dev, reps):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda shape: torch.randn(shape, generator=gen,
                                    device=dev).to(torch.bfloat16)
    H, Hkv, hd = 12, 4, 64
    out = {}
    for what, B, S in (("served", 8, 512), ("long", 2, 4096)):
        q, k, v = (rnd((B, S, h, hd)).transpose(1, 2) for h in (H, Hkv, Hkv))
        fns = {"kernel": lambda: FA.flash_attention_bhsd_cuda(q, k, v),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True)}
        for name, fn in fns.items():
            out[f"flash_{what}_{name}"] = {
                "ms": eager_ms(torch, fn, reps),
                "device_ms": device_ms(torch, fn, reps),
                "kernels": device_kernels(torch, fn)}
    for what, B, T in (("served", 8, 640), ("long", 8, 32768)):
        pos = T - 1
        q = rnd((B, 1, H, hd))[:, 0]
        k, v = (rnd((B, T, Hkv, hd)).transpose(1, 2) for _ in "kv")
        fns = {"kernel": lambda: DA.decode_attention_bhd_cuda(q, k, v, pos),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k, v, enable_gqa=True)[:, :, 0]}
        for name, fn in fns.items():
            out[f"decode_{what}_{name}"] = {
                "ms": eager_ms(torch, fn, reps),
                "device_ms": device_ms(torch, fn, reps),
                "kernels": device_kernels(torch, fn)}
    return out


def plan_sweep(torch, dev, values, reps):
    """Decode at the long shape with the split's block target changed."""
    from repro_torch.kernels import decode_attention as DA
    gen = torch.Generator(device=dev).manual_seed(1)
    B, T, H, Hkv, hd = 8, 32768, 12, 4, 64
    q = torch.randn((B, H, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen, device=dev)
            .bfloat16().transpose(1, 2) for _ in "kv")
    default, out = DA.PLAN_BLOCKS, {}
    try:
        for n in values:
            DA.PLAN_BLOCKS = n
            plan = DA.decode_plan(B, Hkv, H // Hkv, T - 1)
            fn = lambda: DA.decode_attention_bhd_cuda(q, k, v, T - 1)
            out[str(n)] = {"chunk": plan.chunk, "blocks": plan.blocks,
                           "device_ms": device_ms(torch, fn, reps)}
    finally:
        DA.PLAN_BLOCKS = default
    return out


def serve_times(torch, np, dev, steps=32):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Engine
    cfg = get_config("repro-100m")
    model = build_model(cfg)
    engine = Engine(model, model.init(torch.Generator().manual_seed(0), dev),
                    cache_len=512 + steps + 1)
    prompt = np.random.Generator(np.random.PCG64(0)).integers(
        0, cfg.vocab_size, (8, 512)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(prompt).to(dev)}
    prefill, step = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(batch)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
    token = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = engine.decode(cache, token, 512 + i)
        token = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step.append((time.perf_counter() - t0) * 1e3)
    return {"prefill_ms": statistics.median(prefill[1:]),
            "decode_step_ms": statistics.median(step[2:])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--plan-blocks", type=int, nargs="*", default=[],
                    help="also time decode at the long shape with "
                         "decode_attention.PLAN_BLOCKS set to each value "
                         "(checkouts that have decode_plan)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("attention_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    result = {"tree": str(ROOT), "card": smi.stdout.strip().splitlines()[0]
              if smi.returncode == 0 else torch.cuda.get_device_name(0),
              "times": kernel_times(torch, dev, args.reps)}
    if args.plan_blocks:
        result["plan_blocks"] = plan_sweep(torch, dev, args.plan_blocks,
                                           args.reps)
    if args.serve:
        result["serve"] = serve_times(torch, np, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
