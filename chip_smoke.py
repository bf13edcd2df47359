#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path — a checkpointed dense-LM trainer
(``repro-100m`` at full width, bf16) whose swap-out snapshot is quantized
to int8 on the card by the qsnap kernels, written to a CAS image,
restored (decoded on the card) and resumed — and holds every kernel of
that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases; any failure exits nonzero before a result is printed:
  1. build    compile the kernels from the sources in this checkout;
  2. kernels  each kernel against its plain version (bit-equal) and the
              host codec at N in {256, 76800, 28311552, 1000}, f32 and
              bf16, with an all-zero block and exact .5 ties; then their
              times over every float leaf of the repro-100m train state
              (CUDA events, median), beside the plain versions' times and
              the memory-bandwidth bound;
  3. main     launch counts zeroed, then: train a few steps, int8
              swap-out through snapshot_async + AsyncCheckpointer, restore,
              resume; counts read. The tracer's spans split the swap-out
              and the restore into their phases. Then: the host-encoded int8 image of the
              same state dedups 100% against the device-encoded one, the
              device-decoded restore equals the host decoder, a lossless
              snapshot resumes the uninterrupted run bit-exactly, and a
              small f32 model trains to the same losses on the card and on
              the CPU;
  4. report   the kernels line (JSON), the card's name and power limit,
              and the last line {"ok": true, "device": {...}}.

Needs no network and nothing outside this checkout.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# device memory rate by product name, bytes/s (NVIDIA data sheets);
# anything else is taken as an H100 SXM
MEM_RATES = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
F32_RATE = 67e12          # H100 SXM f32 outside the tensor cores, op/s
SIZES = (256, 76_800, 28_311_552, 1000)
KSTEPS, MORE = 4, 2       # steps before the swap-out, steps after resume
BATCH, SEQ = 8, 512


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warmup."""
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


def profile_steps(torch, step, state, batch, reps: int = 2):
    """Profile ``reps`` train steps: wall ms per step, device kernel ms
    per step, the kernels that take the most device time and the host ops
    that take the most host time (self time, per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):                                   # warm
        state, m = step(state, batch)
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            state, m = step(state, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0))
    kernels.sort(key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / reps
    top = [(e.key[:70], dev_us(e) / 1e3 / reps, e.count // reps)
           for e in kernels[:8]]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    top_host = [(e.key[:70], e.self_cpu_time_total / 1e3 / reps,
                 e.count // reps) for e in host[:8]]
    return wall_ms, device_ms, top, top_host


SWAP_SPANS = ("ckpt/save", "ckpt/materialize", "qsnap/quantize", "qsnap/d2h",
              "qsnap/frame", "ckpt/encode", "ckpt/upload", "ckpt/manifest",
              "ckpt/commit")
RESTORE_SPANS = ("ckpt/restore", "restore/plan", "restore/fetch_decode",
                 "restore/assemble", "restore/device_decode")


def span_split(names):
    """Per span name of the port's tracer: (count, summed seconds, seconds
    from the first start to the last end). Spans of one name may run on
    several threads at once, so the sum can exceed the wall interval."""
    from repro_torch.obs.trace import tracer
    from repro_torch.sim.simtime import active_clock
    scale = active_clock().scale                 # paper s -> wall s
    out = {}
    for nm in names:
        sp = tracer().spans(name=nm)
        if sp:
            out[nm] = (len(sp), sum(s.duration for s in sp) * scale,
                       (max(s.t1 for s in sp) - min(s.t0 for s in sp))
                       * scale)
    return out


def log_split(what, split):
    log(f"[spans] {what}: " + "; ".join(
        f"{nm} x{n} sum {tot * 1e3:.3f} ms wall {wall * 1e3:.3f} ms"
        for nm, (n, tot, wall) in split.items()))


def run_app(app, restore_state=None):
    app.start(None, restore_state)
    while not app.is_done():
        time.sleep(0.005)
        check(app._thread.is_alive() or app.is_done(),
              "trainer thread died")
    app.stop()
    return app


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.ckpt import (AsyncCheckpointer, InMemoryStore, restore,
                                  save_checkpoint)
    from repro_torch.ckpt import compression
    from repro_torch.ckpt.layout import host_array, leaf_items
    from repro_torch.ckpt.reader import load_manifest
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, qsnap
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import (TrainerApp, init_state,
                                           make_train_step)
    from repro_torch.models.model import build_model
    from repro_torch.obs.trace import tracer
    from repro_torch.tree import tree_leaves

    dev = resolve_device("cuda")        # also fixes deterministic numerics
    name = torch.cuda.get_device_name(0)
    mem_rate = next((r for k, r in MEM_RATES if k in name), 3.35e12)
    log(f"[card] {name}; memory rate for bounds {mem_rate / 1e12:.2f} TB/s; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    cached = build.library_path("qsnap").exists()
    build.build("qsnap")
    build_s = time.perf_counter() - t0
    log(f"[build] csrc/qsnap.cu -> {build.library_path('qsnap').name} in "
        f"{build_s:.2f} s{' (already built)' if cached else ''}")

    # ---- 2. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    half = torch.arange(127, dtype=torch.float32, device=dev) + 0.5
    ties = torch.cat([torch.tensor([127.0], device=dev), half, -half,
                      torch.zeros(1, device=dev)])   # scale 1.0: .5 ties
    err = {"quantize": 0.0, "dequantize": 0.0}
    diff = lambda a, b: float((a.float() - b.float()).abs().max())
    for n in SIZES:
        base = torch.randn(n, generator=gen, device=dev) * 3
        base[:256] = ties[:n] * 4
        if n >= 768:
            base[256:512] = 0.0                      # an all-zero block
        for dt in (torch.float32, torch.bfloat16):
            x = base.to(dt)
            codes, scales = qsnap.qsnap_quantize_cuda(x)
            pc, ps = qsnap.qsnap_quantize_plain(x)
            hc, hs = compression.quantize_int8(x.float().cpu().numpy())
            torch.cuda.synchronize()
            err["quantize"] = max(err["quantize"], diff(codes, pc),
                                  diff(scales, ps))
            check(torch.equal(codes, pc) and torch.equal(scales, ps),
                  f"quantize != plain at N={n} {dt}")
            check(np.array_equal(codes.cpu().numpy(), hc)
                  and scales.cpu().numpy().tobytes() == hs.tobytes(),
                  f"quantize != host codec at N={n} {dt}")
            for out in (torch.float32, torch.bfloat16):
                got = qsnap.qsnap_dequantize_cuda(codes, scales, out)
                want = qsnap.qsnap_dequantize_plain(pc, ps, out)
                torch.cuda.synchronize()
                err["dequantize"] = max(err["dequantize"], diff(got, want))
                check(torch.equal(got.view(torch.uint8),
                                  want.view(torch.uint8)),
                      f"dequantize != plain at N={n} {dt} -> {out}")
            log(f"[kernels] N={n:>10} {str(dt)[6:]:>8}: quantize and "
                f"dequantize (f32, bf16 out) bit-equal to plain and host")

    cfg = get_config("repro-100m")
    model = build_model(cfg)
    leaves = [t for t in tree_leaves(init_state(model, 0, dev))
              if t.is_floating_point()]
    n_elems = sum(t.numel() for t in leaves)
    encoded = [qsnap.qsnap_quantize_cuda(t.reshape(-1)) for t in leaves]
    big = max(leaves, key=lambda t: t.numel() * t.element_size()).reshape(-1)
    big_c, big_s = qsnap.qsnap_quantize_cuda(big)
    big_ms = {   # one launch on the largest leaf: the kernel without gaps
        "quantize": time_ms(torch, lambda: qsnap.qsnap_quantize_cuda(big), 50),
        "dequantize": time_ms(torch, lambda: qsnap.qsnap_dequantize_cuda(
            big_c, big_s, big.dtype), 50)}
    big_bytes = big.numel() * big.element_size() + big_c.numel() \
        + 4 * big_s.numel()
    big_bound = big_bytes / mem_rate * 1e3
    times = {
        "quantize": (
            time_ms(torch, lambda: [qsnap.qsnap_quantize_cuda(t.reshape(-1))
                                    for t in leaves], 20),
            time_ms(torch, lambda: [qsnap.qsnap_quantize_plain(t.reshape(-1))
                                    for t in leaves], 5)),
        "dequantize": (
            time_ms(torch, lambda: [qsnap.qsnap_dequantize_cuda(c, s, t.dtype)
                                    for t, (c, s) in zip(leaves, encoded)],
                    20),
            time_ms(torch, lambda: [qsnap.qsnap_dequantize_plain(c, s,
                                                                 t.dtype)
                                    for t, (c, s) in zip(leaves, encoded)],
                    5)),
    }
    # least work: each input read once, each output written once
    code_bytes = sum(c.numel() + 4 * s.numel() for c, s in encoded)
    leaf_bytes = sum(t.numel() * t.element_size() for t in leaves)
    bounds = {}
    for k, ops_per_elem in (("quantize", 6), ("dequantize", 1)):
        bytes_ms = (leaf_bytes + code_bytes) / mem_rate * 1e3
        ops_ms = ops_per_elem * n_elems / F32_RATE * 1e3
        bounds[k] = (max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms >= ops_ms else "operations")
    for k, (ms, plain_ms) in times.items():
        log(f"[kernels] {k} over the {len(leaves)} float leaves of the "
            f"repro-100m state ({n_elems:,} elements, "
            f"{(leaf_bytes + code_bytes) / 1e9:.3f} GB moved): "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bounds[k][0]:.4f} "
            f"ms ({bounds[k][1]}); no single PyTorch call computes it")
        log(f"[kernels] {k} one launch on the largest leaf "
            f"({big.numel():,} {str(big.dtype)[6:]}): {big_ms[k]:.4f} ms, "
            f"bound {big_bound:.4f} ms")
    del leaves, encoded, big, big_c, big_s

    # ---- 3. main path -----------------------------------------------------
    opt = AdamWConfig(warmup_steps=2, total_steps=KSTEPS + MORE)

    def trainer(n_steps, c=cfg, batch=BATCH, seq=SEQ, device=dev):
        return TrainerApp(c, global_batch=batch, seq_len=seq,
                          n_steps=n_steps, opt=opt, device=device)

    log(f"[main] {cfg.name} {cfg.dtype}: {cfg.param_count():,} params, "
        f"batch {BATCH} x seq {SEQ}, {KSTEPS} steps, int8 swap-out, restore, "
        f"{MORE} more steps")
    torch.cuda.reset_peak_memory_stats()
    for k in qsnap.LAUNCHES:
        qsnap.LAUNCHES[k] = 0
    app = run_app(trainer(KSTEPS))
    tracer().reset()
    handle = app.snapshot_async(codec="int8")
    store = InMemoryStore()
    ck = AsyncCheckpointer(store, "job", codec="int8")
    t0 = time.perf_counter()
    ck.save(KSTEPS, handle)
    ck.wait()
    swap_s = time.perf_counter() - t0
    quant_launches = qsnap.LAUNCHES["quantize"]
    swap_split = span_split(SWAP_SPANS)
    tracer().reset()
    t0 = time.perf_counter()
    snap, man_dev = restore(store, "job", device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_split = span_split(RESTORE_SPANS)
    resumed = run_app(trainer(KSTEPS + MORE), snap)
    launches = dict(qsnap.LAUNCHES)
    ck.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    state = app.checkpoint_state()
    n_float = sum(1 for t in tree_leaves(state["state"])
                  if t.is_floating_point())
    losses = app.losses + resumed.losses
    log(f"[main] losses {losses}")
    check(all(np.isfinite(losses)) and len(losses) == KSTEPS + MORE,
          "losses not finite")
    check(launches["quantize"] == quant_launches == n_float,
          f"quantize launches {launches['quantize']} != {n_float} float "
          f"leaves")
    check(launches["dequantize"] == n_float,
          f"dequantize launches {launches['dequantize']} != {n_float}")
    for a, b in zip(tree_leaves(state["state"]), tree_leaves(snap["state"])):
        check(a.shape == b.shape and a.dtype == b.dtype
              and b.device.type == "cuda", "restored leaf shape/dtype/device")
        check(bool(torch.isfinite(b.float()).all()), "restored leaf finite")

    # the device-encoded image dedups 100% against the host-encoded one
    man_host = save_checkpoint(store, "job", KSTEPS + 1, state, codec="int8")
    dedup = man_host.metadata["dedup"]
    check(dedup["dedup_misses"] == 0 and dedup["bytes_written"] == 0,
          f"host int8 image did not dedup against the device one: {dedup}")
    # the device-decoded restore is what the host decoder gives
    man = load_manifest(store, "job", KSTEPS)
    restored = dict(leaf_items(snap))
    for lname, li in man.leaves.items():
        if li.kind != "array":
            continue
        raw = compression.decode(store.get(li.chunks[0].key), li.dtype,
                                 man.codec)
        check(host_array(restored[lname]).tobytes() == raw,
              f"device decode of {lname} != host decoder")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state["state"]))
    int8_bytes = sum(c.nbytes for li in man_dev.leaves.values()
                     for c in li.chunks)
    log(f"[main] device-exit bytes: state {state_bytes:,} -> int8 payloads "
        f"{int8_bytes:,} ({state_bytes / int8_bytes:.3f}x); dedup of the "
        f"host-encoded image: {dedup['dedup_hits']} hits, 0 misses")
    log(f"[main] capture stall {app.ckpt_stalls[-1] * 1e6:.1f} us; step time "
        f"median {statistics.median(app.step_times[1:]) * 1e3:.2f} ms (first "
        f"step {app.step_times[0]:.2f} s); swap-out encode+save "
        f"{swap_s:.3f} s; restore {restore_s:.3f} s; peak memory "
        f"{peak_gb:.2f} GB")
    log_split("swap-out", swap_split)
    log_split("restore", restore_split)
    check(set(swap_split) == set(SWAP_SPANS)
          and set(restore_split) == set(RESTORE_SPANS),
          f"spans missing: {set(SWAP_SPANS) - set(swap_split)} "
          f"{set(RESTORE_SPANS) - set(restore_split)}")
    del snap, resumed

    # a lossless image resumes the uninterrupted run bit-exactly
    straight = run_app(trainer(KSTEPS + MORE))
    raw_store = InMemoryStore()
    save_checkpoint(raw_store, "job", KSTEPS, app.snapshot_async(),
                    codec="raw")
    again = run_app(trainer(KSTEPS + MORE),
                    restore(raw_store, "job", device=dev)[0])
    check(app.losses == straight.losses[:KSTEPS], "runs not deterministic")
    check(again.losses == straight.losses[KSTEPS:],
          f"lossless resume diverged: {again.losses} vs "
          f"{straight.losses[KSTEPS:]}")
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(again.checkpoint_state()["state"]),
        tree_leaves(straight.checkpoint_state()["state"]))),
        "lossless resume: final state differs")
    log(f"[main] lossless resume bit-exact: losses {again.losses}")
    del app, straight, again

    # reference on a small input: the card agrees with the CPU
    small = dataclasses.replace(reduced(cfg), dtype="float32")
    on_card = run_app(trainer(3, small, 2, 32)).losses
    on_cpu = run_app(trainer(3, small, 2, 32, "cpu")).losses
    check(np.allclose(on_card, on_cpu, rtol=1e-4, atol=0),
          f"card {on_card} vs cpu {on_cpu}")
    log(f"[main] reduced f32 model, card vs cpu losses agree within 1e-4: "
        f"{on_card} / {on_cpu}")

    # where a full-width train step's time goes (outside the counted path)
    state = init_state(model, 0, dev)
    batch = TokenPipeline(cfg, BATCH, SEQ).next(dev)
    wall_ms, device_ms, top, top_host = profile_steps(
        torch, make_train_step(model, opt), state, batch)
    log(f"[profile] train step: wall {wall_ms:.2f} ms, device kernels "
        f"{device_ms:.2f} ms (busy share {device_ms / wall_ms:.3f})")
    for kname, ms, count in top:
        log(f"[profile]   device {ms:9.3f} ms  x{count:<4d} {kname}")
    for kname, ms, count in top_host:
        log(f"[profile]   host   {ms:9.3f} ms  x{count:<4d} {kname}")
    del state

    # ---- 4. report --------------------------------------------------------
    src = "src/repro_torch/kernels/csrc/qsnap.cu"
    rows = []
    for k, line in (("quantize", 29), ("dequantize", 41)):
        ms, plain_ms = times[k]
        rows.append({
            "name": f"qsnap_{k}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/qsnap.py:{line}",
            "launches": launches[k], "max_abs_err": err[k],
            "bitexact": err[k] == 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": None, "elements": n_elems,
            "largest_leaf_ms": big_ms[k], "largest_leaf_bound_ms": big_bound})
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
