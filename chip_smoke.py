#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's paths at the full width of ``repro-100m``, of
``jamba-v0.1-52b`` (one 8-layer period) and of ``xlstm-125m``,
``seamless-m4t-medium``, ``internvl2-2b`` and ``gemma3-12b`` (every
published width and depth) in bf16 and holds every kernel of them
against its plain PyTorch version:
  * training — a checkpointed dense-LM trainer whose swap-out snapshot is
    quantized to int8 on the card by the qsnap kernels, written to a CAS
    image, restored (decoded on the card) and resumed;
  * serving — prefill through the flash-attention kernel, greedy decode
    through the decode-attention kernel, suspended mid-generation to a
    lossless image, restored on the card and resumed with the same tokens;
  * the CACS control plane for one job — both jobs submitted to a
    ``CACSService`` and suspended and resumed through it: the trainer's
    swap-out quantized on the card, its resume decoded on the card;
  * the global scheduler, replication and the serving fleet — a
    high-priority server preempts the int8 trainer off the card and the
    scheduler swaps the trainer back when the server is done; a
    replicated trainer fails over to a standby cloud; fleet replicas
    cold-start from a seed image and one is parked and unparked;
  * the MoE and Mamba blocks — jamba-v0.1-52b at full width (one 8-layer
    period) served and suspended mid-generation with its KV cache and
    Mamba state, resumed with the same tokens;
  * the xLSTM, encoder-decoder and vision-frontend families and gemma3 —
    each served at full width through the attention kernels (head dim
    256 for gemma3), an xLSTM server suspended with its recurrent state
    through the service and resumed with the same tokens;
  * the distributed layer — two ranks sharing the card over gloo train a
    sharded state on one mesh, save it, restore it on another mesh (the
    migration core), decode a sharded int8 image on the card and reduce
    gradients across two pods through compressed payloads.

    python3 chip_smoke.py

Phases; any failure exits nonzero before a result is printed:
  1. build    compile the kernels from the sources in this checkout, one
              nvcc per source, all started together;
  2. kernels  qsnap against its plain version (bit-equal) and the host
              codec at N in {256, 76800, 28311552, 1000}, f32 and bf16,
              with an all-zero block and exact .5 ties; dequantize also at
              the edges of its CTA tile (one block, a tile less and more
              one block, a tile, three tiles and two blocks), f32 and bf16
              out, codes at +-127 and an all-zero block, two launches
              equal; then their times over every float leaf of the
              repro-100m train state and on the largest leaf (dequantize
              also the largest bf16 leaf), eager (CUDA events, median) and
              on the device (CUDA-graph replay), beside the plain versions'
              times, the memory-bandwidth bound and, for dequantize, one
              torch.Tensor.copy_ moving the same bytes (the card's
              reachable copy rate, a yardstick only). The attention
              kernels against their plain versions on the case grids of
              tests/test_kernels.py and the served shapes (f32 within
              2e-5, bf16 within 2e-2),
              two launches bit-equal, a skipped tile equal to a masked one,
              decode blind to poisoned slots past pos; the same on the edges
              of the redesigned kernels (ragged S and kv_len, g in
              {1, 3, 4, 8, 16}, a window shorter than a tile, hd 32 to 128;
              decode at pos 0, at a chunk's edges and at T - 1), and
              unaligned views refused; their times at the served shapes and
              one long case each, beside the plain versions',
              scaled_dot_product_attention's (timed only, as the yardstick;
              the port never calls it) and the bound: eager (one call between
              two events, host work included) and device (the call captured
              in a CUDA graph, replayed between two events);
  3. main     launch counts zeroed, then: train a few steps, int8
              swap-out through snapshot_async + AsyncCheckpointer, restore,
              resume; counts read. The tracer's spans split the swap-out
              and the restore into their phases. Then: the host-encoded int8 image of the
              same state dedups 100% against the device-encoded one, the
              device-decoded restore equals the host decoder, a lossless
              snapshot resumes the uninterrupted run bit-exactly, and a
              small f32 model trains to the same losses on the card and on
              the CPU; a profiled train step;
  4. serve    launch counts zeroed, then Engine.generate: batch 8, prompt
              512, 128 new tokens (12 flash launches in the prefill, 12 per
              decode step); counts read; prefill time, decode step and
              tokens/s. A ServeApp suspended after a few tokens
              (snapshot_async -> CAS writer, lossless -> restore on the
              card -> start) resumes the uninterrupted stream bit for bit.
              A reduced f32 model's logits through the kernels agree with
              the oracles' (impl="ref") on the card; a profiled decode step;
  5. service  launch counts zeroed, then through CACSService (Snooze
              backend, in-memory store): a trainer job (the phase 3
              arguments) takes a few steps, a lossless checkpoint_now, a
              suspend with swap_codec="int8" (one quantize launch per
              float leaf) and a resume (one dequantize launch per float
              leaf, the restored leaves on cuda and finite), then runs to
              its end; counts read. A second trainer job without a swap
              codec is suspended past step 4 and resumed: its losses equal
              the uninterrupted run's bit for bit. A ServeApp job (batch 8,
              prompt 512, 128 tokens, paced) suspended after 4 tokens and
              resumed through the service emits phase 4's tokens, its flash
              and decode launches counted;
  6. sched    launch counts zeroed before each part and read after it:
              (a) a GlobalScheduler over a one-host Snooze cloud runs a
              priority-1 int8 trainer; a priority-9 ServeApp (phase 4's
              shapes) preempts it with no call from this script (33
              quantize launches, no attention launch; the decision trace
              shows the preemption, then the placement), emits phase 4's
              tokens (12 flash, 12 x 127 decode launches); when the
              finished server is deleted the scheduler resumes the trainer
              itself (33 dequantize launches, leaves on cuda and finite),
              which runs to its last step; device memory at three points;
              (b) a lossless trainer on Snooze with its images replicated
              to an OpenStack standby: after an explicit image replicates,
              a whole-cloud outage of the primary (ChaosController,
              CLOUD_OUTAGE) fails it over to the standby with zero chunks
              re-uploaded, restored on the card, its losses equal the
              uninterrupted run's bit for bit; (c) a FleetController
              cold-starts two ServeApp replicas from a seed image by prefix
              adoption (zero re-uploads, leaves on cuda), parks one by
              scale-in mid-generation and unparks it; both emit phase 4's
              tokens;
  7. jamba    jamba-v0.1-52b at full width, depth cut to one 8-layer
              period (1 attention, 7 Mamba, 4 MoE, 4 MLP layers;
              13,295,235,072 parameters drawn on the card, counted from the
              built tree): launch counts zeroed, then Engine.generate at
              batch 8, prompt 512 (two scan chunks), 32 new tokens (1 flash
              launch in the prefill, 1 per decode step, none from the Mamba
              and MoE layers); counts read; prefill, decode step, a
              profiled decode step's busy share. The flash and decode
              kernels against their plain versions at jamba's served shapes
              (hd 128, 4 q-heads per kv-head), timed beside sdpa and their
              bounds. A ServeApp suspended after 4 tokens (its KV cache and
              each Mamba layer's f32 h and conv window in a lossless image,
              in host memory when it fits, else on disk) restores with
              every leaf on cuda and resumes the uninterrupted stream bit
              for bit; image bytes, swap-out, restore, capture stall, peak
              device memory, host MemAvailable. A reduced f32 jamba's logits
              through the kernels agree with the oracles' on the card;
  8. p8       each model at every published width and depth, drawn on
              the card and freed before the next; launch counts zeroed just
              before each Engine.generate and read just after:
              (a) xlstm-125m (143,868,720 params) at batch 8 x prompt 512
              (four mLSTM chunks), 32 new tokens: no attention launch; a
              ServeApp suspended mid-generation through CACSService and
              resumed: its image holds the mLSTM C (113,246,208 B), n and
              conv and the sLSTM c, n, h, m, every leaf on cuda, the
              states f32, the tokens Engine.generate's bit for bit;
              (b) seamless-m4t-medium (877,197,312 params), frames [4,
              4096, 1024] from the seed, prompt 128, 32 new tokens: 36
              flash launches a prefill (12 encoder, 12 self, 12 cross), 24
              decode launches a step (12 self, 12 cross-attention at pos
              4095), mk/mv 805,306,368 B; (c) internvl2-2b (1,889,634,304
              params), 256 patch embeddings + prompt 512, 32 new tokens: 24
              flash a prefill, 24 decode a step, decode from pos 768;
              (d) gemma3-12b (11,765,395,200 params, head dim 256), batch
              4 x prompt 1536, 32 new tokens: 48 flash a prefill (40
              windowed), a step 8 decode launches and 40 attention_ref
              decodes (the windowed layers), peak device memory. For
              (b)-(d) the first-step logits through the kernels against
              impl="ref" within a relative L2 error of 5e-2 (bf16). The
              attention kernels at gemma3's served shapes (global and
              window 1024 flash, decode at pos 1567) and seamless's
              (non-causal encoder flash, cross-attention decode over 4,096
              slots), checked and timed as in phase 7; the phase's wall
              time;
  9. dist     two ranks sharing the card (gloo through host memory;
              launch.mesh.spawn), repro-100m bf16 at full width, batch 8
              x 512, launch counts read in each rank: (a) 4 one-process
              steps; 2 sharded steps on mesh A (data 1, model 2), their
              losses and every local shard equal to the one-process steps'
              bit for bit; a lossless save from both ranks; a restore on
              mesh B (data 2, model 1, FSDP), every local shard equal to
              the saved state's; 2 steps on B, the step-4 loss within 1e-2
              of the one-process run; (b) the B state saved as int8 (0
              quantize launches: DTensor leaves take the host codec) and
              restored on A decoded on the card, one dequantize launch
              for each (region, int8 chunk) overlap in the manifest, every
              shard equal to the host decoder's bytes; (c) one
              make_compressed_train_step on a (pod 2) mesh, 4 sequences a
              pod, for none, bf16 and int8: the loss within 1e-2 of the
              one-process step's, the pod-mean gradient within 2e-2 (none,
              bf16) and 4e-2 (int8) relative L2 of the one-process
              gradient, every param within 2 lr + one bf16 ulp, the payload
              a pod sends against the gradient's f32 bytes; save and
              restore times beside their bytes, each part's wall time;
 10. report   the kernels line (JSON: launches on the main path, through
              the service, in phase 6, in phase 7, per phase 8 model and
              in phase 9), the card's name and power limit, and the last
              line {"ok": true, "device": {...}}.

Needs no network and nothing outside this checkout.
"""
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# device memory rate by product name, bytes/s (NVIDIA data sheets);
# anything else is taken as an H100 SXM
MEM_RATES = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
F32_RATE = 67e12          # H100 SXM f32 outside the tensor cores, op/s
BF16_RATE = 989e12        # H100 SXM bf16 tensor cores, dense, op/s
SIZES = (256, 76_800, 28_311_552, 1000)
KSTEPS, MORE = 4, 2       # steps before the swap-out, steps after resume
BATCH, SEQ = 8, 512
KERNELS = ("qsnap", "flash_attention", "decode_attention")
# the attention grids of tests/test_kernels.py (without the TPU block size)
FLASH_CASES = ((2, 128, 4, 2, 64, None), (1, 256, 8, 8, 128, None),
               (2, 192, 4, 2, 64, 64), (1, 128, 6, 2, 96, None),
               (1, 96, 4, 1, 128, 32), (1, 160, 4, 2, 256, None),
               (1, 200, 4, 2, 256, 64))         # (B, S, H, Hkv, hd, window)
DECODE_CASES = ((2, 512, 8, 2, 64, 300), (1, 1024, 4, 4, 128, 1023),
                (3, 256, 8, 4, 96, 0), (1, 640, 16, 2, 128, 400),
                (2, 700, 4, 2, 256, 650))
# the edges of the bf16 tensor-core flash design and of the decode split,
# as in tests/test_torch_cuda.py
FLASH_EDGE_CASES = ((2, 200, 300, 6, 2, 64, False, None, 277),
                    (1, 333, 333, 4, 4, 32, True, None, None),
                    (2, 200, 200, 12, 4, 64, True, None, None),
                    (1, 130, 130, 8, 2, 128, True, None, 100),
                    (1, 150, 150, 8, 1, 96, True, None, None),
                    (1, 300, 300, 6, 2, 64, True, 20, None),
                    (1, 257, 257, 4, 2, 96, True, 48, None),
                    (2, 100, 300, 4, 2, 256, False, None, 250),
                    (1, 150, 150, 8, 1, 256, True, 40, None))
# (B, S, T, H, Hkv, hd, causal, window, kv_len)
DECODE_EDGE_CASES = ((1, 4096, 4, 1, 128, 0), (1, 4096, 4, 1, 128, 63),
                     (1, 4096, 4, 1, 128, 64), (1, 4096, 4, 1, 128, 4095),
                     (8, 16384, 8, 8, 64, 16127), (8, 16384, 8, 8, 64, 16128),
                     (8, 16384, 8, 8, 64, 16383), (2, 2048, 16, 1, 64, 1000),
                     (2, 1024, 16, 2, 96, 511), (3, 777, 6, 2, 32, 776),
                     (1, 4096, 16, 8, 256, 4095), (2, 2048, 8, 1, 256, 1000))
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# serving: batch, prompt, new tokens; the cache holds prompt + tokens
S_BATCH, S_PROMPT, S_TOKENS = 8, 512, 128
S_CACHE = S_PROMPT + S_TOKENS
PREEMPT_STEPS = 16          # the preempted trainer's steps (phase 6)
FLEET_SEED, FLEET_TOKENS = 4, 32   # the fleet's seed and replica tokens
# jamba (phase 7): batch, prompt (two scan chunks), new tokens, cache; the
# parameters of one 8-layer period at full width, by arithmetic
J_BATCH, J_PROMPT, J_TOKENS, J_CACHE = 8, 512, 32, 640
J_PARAMS = 13_295_235_072
# phase 8: each family at full width (every published width and depth):
# its parameters (the reference's abstract_params), batch, prompt, new
# tokens and cache slots (a vlm's cache also holds its patch embeddings)
P8 = {"xlstm-125m": (143_868_720, 8, 512, 32, 544),
      "seamless-m4t-medium": (877_197_312, 4, 128, 32, 160),
      "internvl2-2b": (1_889_634_304, 8, 512, 32, 800),
      "gemma3-12b": (11_765_395_200, 4, 1536, 32, 1568)}
XLSTM_C = ((6, 8, 4, 384, 384), 113_246_208)   # the mLSTM C, f32: bytes
SEAMLESS_MEMORY_BYTES = 805_306_368  # mk + mv: 12 x 2 x 4 x 4096 x 16 x 64
SEAMLESS_LAUNCHES = (36, 24)         # flash a prefill, decode a step
GEMMA3_LAYERS = (40, 8)              # windowed, global
# the kernel path's first-step logits against the oracles' (impl="ref")
# in bf16: each of up to 48 layers rounds its attention output to bf16
# (8 mantissa bits) in other places on the two paths, so the logits may
# part by a few parts in a hundred of their norm; a wrong kernel parts
# them by their whole size
LOGIT_REL_TOL = 5e-2
LONG_FLASH = (2, 4096)      # batch, sequence of the long prefill case
LONG_DECODE = (8, 32768)    # batch, cache slots of the long decode case


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


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn``: the call captured in a CUDA graph,
    replayed ``reps`` times between two events, divided by ``reps``. The
    host's work for the call (checks, allocation, launch) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm on the capture stream
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


def profile_steps(torch, step, reps: int = 2):
    """Profile ``reps`` calls of ``step`` (each ends in a host sync): wall
    ms per call, device kernel ms per call, the kernels that take the most
    device time and the host ops that take the most host time (self time,
    per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):                                   # warm
        step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
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


def log_profile(what, prof):
    wall_ms, device_ms, top, top_host = prof
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device kernels "
        f"{device_ms:.2f} ms (busy share {device_ms / wall_ms:.3f})")
    for kname, ms, count in top:
        log(f"[profile]   device {ms:9.3f} ms  x{count:<4d} {kname}")
    for kname, ms, count in top_host:
        log(f"[profile]   host   {ms:9.3f} ms  x{count:<4d} {kname}")


def log_split(what, split):
    log(f"[spans] {what}: " + "; ".join(
        f"{nm} x{n} sum {tot * 1e3:.3f} ms wall {wall * 1e3:.3f} ms"
        for nm, (n, tot, wall) in split.items()))


def dequantize_edges(torch, qsnap, dev, gen, err):
    """Phase 2, qsnap: the dequantize kernel bit-equal to its plain version
    at sizes on the edges of its CTA tile, f32 and bf16 out, with runs of
    codes at +127 and -127 and an all-zero block; two launches equal."""
    tile = qsnap.dequantize_tile()
    sizes = (256, tile - 256, tile, tile + 256, 3 * tile + 512)
    for n in sizes:
        codes = torch.randint(-127, 128, (n,), generator=gen, device=dev,
                              dtype=torch.int16).to(torch.int8)
        scales = torch.rand(n // 256, generator=gen, device=dev) * 0.1 + 1e-3
        codes[:64], codes[64:128] = 127, -127
        if n >= 768:
            codes[256:512], scales[1] = 0, 1.0      # an all-zero block
            codes[-256:] = -127
        for out in (torch.float32, torch.bfloat16):
            got = qsnap.qsnap_dequantize_cuda(codes, scales, out)
            want = qsnap.qsnap_dequantize_plain(codes, scales, out)
            again = qsnap.qsnap_dequantize_cuda(codes, scales, out)
            torch.cuda.synchronize()
            err["dequantize"] = max(err["dequantize"], float(
                (got.float() - want.float()).abs().max()))
            check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
                  f"dequantize != plain at the tile edge N={n} -> {out}")
            check(torch.equal(got.view(torch.uint8),
                              again.view(torch.uint8)),
                  f"dequantize: two launches differ at N={n} -> {out}")
    log(f"[kernels] dequantize at the edges of its {tile}-code tile, N in "
        f"{sizes}, f32 and bf16 out, codes at +-127 and an all-zero block: "
        f"bit-equal to plain, two launches equal")


def attn_bound(n_bytes: int, flops: int, mem_rate: float):
    """Least time for the work: the larger of its bytes over the memory
    rate and its operations over the bf16 tensor-core peak."""
    b_ms, o_ms = n_bytes / mem_rate * 1e3, flops / BF16_RATE * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def attention_kernels(torch, dev, cfg, mem_rate):
    """Phase 2, attention: the flash and decode kernels against their
    plain versions, then timed at the served shapes and one long case."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    rnd = attn_rnd(torch, dev, 1)
    err = lambda a, b: float((a.float() - b.float()).abs().max())

    for dname, tol in ATTN_TOL.items():
        dt = getattr(torch, dname)
        for B, S, H, Hkv, hd, w in FLASH_CASES:
            q, k, v = (rnd(sh, dt) for sh in ((B, H, S, hd),
                                              (B, Hkv, S, hd),
                                              (B, Hkv, S, hd)))
            got = FA.flash_attention_bhsd_cuda(q, k, v, window=w)
            e = err(got, FA.flash_attention_bhsd_plain(q, k, v, window=w))
            check(e <= tol, f"flash {dname} {(B, S, H, Hkv, hd, w)}: "
                  f"max error {e} > {tol}")
            check(torch.equal(got, FA.flash_attention_bhsd_cuda(
                q, k, v, window=w)), "flash: two launches differ")
            check(torch.equal(got, FA.flash_attention_bhsd_cuda(
                q, k, v, window=w, skip_masked_tiles=False)),
                "flash: a skipped tile differs from a masked one")
        for B, T, H, Hkv, hd, pos in DECODE_CASES:
            q, k, v = (rnd(sh, dt) for sh in ((B, H, hd), (B, Hkv, T, hd),
                                              (B, Hkv, T, hd)))
            got = DA.decode_attention_bhd_cuda(q, k, v, pos)
            e = err(got, DA.decode_attention_bhd_plain(q, k, v, pos))
            check(e <= tol, f"decode {dname} {(B, T, H, Hkv, hd, pos)}: "
                  f"max error {e} > {tol}")
            check(torch.equal(got, DA.decode_attention_bhd_cuda(
                q, k, v, pos)), "decode: two launches differ")
            k[:, :, pos + 1:], v[:, :, pos + 1:] = 1e4, -1e4
            check(torch.equal(got, DA.decode_attention_bhd_cuda(
                q, k, v, pos)), "decode: slots past pos changed the output")
        for B, S, T, H, Hkv, hd, causal, w, kv_len in FLASH_EDGE_CASES:
            q, k, v = (rnd(sh, dt) for sh in ((B, H, S, hd),
                                              (B, Hkv, T, hd),
                                              (B, Hkv, T, hd)))
            kw = dict(causal=causal, window=w, kv_len=kv_len)
            got = FA.flash_attention_bhsd_cuda(q, k, v, **kw)
            e = err(got, FA.flash_attention_bhsd_plain(q, k, v, **kw))
            check(e <= tol, f"flash {dname} edge {(B, S, T, H, Hkv, hd)} "
                  f"{kw}: max error {e} > {tol}")
            check(torch.equal(got, FA.flash_attention_bhsd_cuda(
                q, k, v, **kw)), "flash edge: two launches differ")
            check(torch.equal(got, FA.flash_attention_bhsd_cuda(
                q, k, v, skip_masked_tiles=False, **kw)),
                "flash edge: a skipped tile differs from a masked one")
            if kv_len is not None:
                k[:, :, kv_len:], v[:, :, kv_len:] = 1e4, float("nan")
                check(torch.equal(got, FA.flash_attention_bhsd_cuda(
                    q, k, v, **kw)), "flash: keys past kv_len were read")
        for B, T, H, Hkv, hd, pos in DECODE_EDGE_CASES:
            q, k, v = (rnd(sh, dt) for sh in ((B, H, hd), (B, Hkv, T, hd),
                                              (B, Hkv, T, hd)))
            got = DA.decode_attention_bhd_cuda(q, k, v, pos)
            e = err(got, DA.decode_attention_bhd_plain(q, k, v, pos))
            check(e <= tol, f"decode {dname} edge {(B, T, H, Hkv, hd, pos)}"
                  f": max error {e} > {tol}")
            check(torch.equal(got, DA.decode_attention_bhd_cuda(
                q, k, v, pos)), "decode edge: two launches differ")
            k[:, :, pos + 1:], v[:, :, pos + 1:] = 1e4, -1e4
            check(torch.equal(got, DA.decode_attention_bhd_cuda(
                q, k, v, pos)), "decode edge: slots past pos changed it")
            del q, k, v
        torch.cuda.synchronize()
        n_win = sum(c[-1] is not None for c in FLASH_CASES)
        log(f"[kernels] attention {dname}: flash on {len(FLASH_CASES)} "
            f"cases ({n_win} windowed) and {len(FLASH_EDGE_CASES)} edge "
            f"cases, decode on {len(DECODE_CASES)} cases and "
            f"{len(DECODE_EDGE_CASES)} edge cases within {tol} of plain; two "
            f"launches bit-equal; skipped tiles equal masked ones; keys past "
            f"kv_len and slots past pos poisoned change nothing")
    refuse_unaligned(torch, FA, DA, rnd)

    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}
    for what, B, S in (("served", S_BATCH, S_PROMPT), ("long", *LONG_FLASH)):
        out[("flash", what)] = flash_row(torch, FA, rnd, B, S, H, Hkv, hd,
                                         mem_rate, what)
    for what, B, T in (("served", S_BATCH, S_CACHE),
                        ("long", *LONG_DECODE)):
        out[("decode", what)] = decode_row(torch, DA, rnd, B, T, H, Hkv, hd,
                                           mem_rate, what)
    for (name, what), r in out.items():
        log_attn_row(name, what, r)
    return out


def attn_rnd(torch, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lambda shape, dt: torch.randn(shape, generator=gen,
                                         device=dev).to(dt)


def flash_row(torch, FA, rnd, B, S, H, Hkv, hd, mem_rate, what,
              T=None, causal=True, window=None):
    """The flash kernel at one bf16 shape of a main path (causal, windowed
    or, over T != S keys, non-causal), in that path's layout ([B,S,H,hd]
    tensors seen as [B,H,S,hd]): checked against its plain version and
    sdpa, timed beside both, with its bound (the visible query-key pairs'
    products)."""
    import torch.nn.functional as F
    T = S if T is None else T
    q = rnd((B, S, H, hd), torch.bfloat16).transpose(1, 2)
    k, v = (rnd((B, T, Hkv, hd), torch.bfloat16).transpose(1, 2)
            for _ in "kv")
    kw = dict(causal=causal, window=window)
    got = FA.flash_attention_bhsd_cuda(q, k, v, **kw)
    mask = None
    if window is not None:        # sdpa takes a window only as a mask
        rel = torch.arange(S, device=q.device)[:, None] - torch.arange(
            T, device=q.device)[None, :]
        mask = (rel >= 0) & (rel < window)
    lib = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    err = lambda a, b: float((a.float() - b.float()).abs().max())
    e = err(got, FA.flash_attention_bhsd_plain(q, k, v, **kw))
    check(e <= ATTN_TOL["bfloat16"], f"flash {what}: max error {e}")
    check(err(got, lib()) <= ATTN_TOL["bfloat16"],
          f"flash {what}: sdpa computes another function")
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    if not causal:
        pairs = S * T
    elif window is None:
        pairs = S * (S + 1) // 2
    else:
        pairs = sum(min(i + 1, window) for i in range(S))
    bound = attn_bound(n_bytes, 4 * B * H * hd * pairs, mem_rate)
    how = ("causal" if window is None else f"window {window}") if causal \
        else "non-causal"
    return dict(
        shape=f"q [{B},{H},{S},{hd}] kv [{B},{Hkv},{T},{hd}] bf16 {how}",
        max_abs_err=e,
        ms=time_ms(torch, lambda: FA.flash_attention_bhsd_cuda(
            q, k, v, **kw), 50),
        device_ms=graph_ms(
            torch, lambda: FA.flash_attention_bhsd_cuda(q, k, v, **kw), 100),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_bhsd_plain(
            q, k, v, **kw), 5),
        library_ms=time_ms(torch, lib, 50),
        library_device_ms=graph_ms(torch, lib, 100),
        bound_ms=bound[0], bound_by=bound[1])


def decode_row(torch, DA, rnd, B, T, H, Hkv, hd, mem_rate, what):
    """The decode kernel at one bf16 shape of a main path, at pos T - 1, in
    that path's cache layout: checked, timed and bounded as flash_row."""
    import torch.nn.functional as F
    pos = T - 1
    q = rnd((B, 1, H, hd), torch.bfloat16)[:, 0]
    k, v = (rnd((B, T, Hkv, hd), torch.bfloat16).transpose(1, 2)
            for _ in "kv")
    got = DA.decode_attention_bhd_cuda(q, k, v, pos)
    lib = lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, enable_gqa=True)[:, :, 0]
    err = lambda a, b: float((a.float() - b.float()).abs().max())
    e = err(got, DA.decode_attention_bhd_plain(q, k, v, pos))
    check(e <= ATTN_TOL["bfloat16"], f"decode {what}: max error {e}")
    check(err(got, lib()) <= ATTN_TOL["bfloat16"],
          f"decode {what}: sdpa computes another function")
    n_bytes = 2 * (2 * q.numel() + 2 * B * Hkv * (pos + 1) * hd)
    bound = attn_bound(n_bytes, 4 * B * H * hd * (pos + 1), mem_rate)
    return dict(
        shape=f"q [{B},{H},{hd}] cache [{B},{Hkv},{T},{hd}] bf16 at "
              f"pos {pos}",
        max_abs_err=e,
        ms=time_ms(torch, lambda: DA.decode_attention_bhd_cuda(
            q, k, v, pos), 50),
        device_ms=graph_ms(torch, lambda: DA.decode_attention_bhd_cuda(
            q, k, v, pos), 100),
        plain_ms=time_ms(torch, lambda: DA.decode_attention_bhd_plain(
            q, k, v, pos), 5),
        library_ms=time_ms(torch, lib, 50),
        library_device_ms=graph_ms(torch, lib, 100),
        bound_ms=bound[0], bound_by=bound[1])


def log_attn_row(name, what, r):
    log(f"[kernels] {name} {what} {r['shape']}: {r['ms']:.4f} ms "
        f"(device {r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
        f"sdpa {r['library_ms']:.4f} ms (device "
        f"{r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); max error vs plain {r['max_abs_err']:.3g}")


def refuse_unaligned(torch, FA, DA, rnd):
    """The 16-byte copies: a bf16 view whose base is off 16 bytes, or whose
    rows are not 16 bytes apart, is refused by both wrappers."""
    bf16 = torch.bfloat16
    off = lambda *sh: rnd((*sh[:-1], sh[-1] + 8), bf16)[..., 1:sh[-1] + 1]
    ragged = lambda *sh: rnd((*sh[:-1], sh[-1] + 4), bf16)[..., :sh[-1]]
    q, kv = rnd((1, 4, 64, 64), bf16), rnd((1, 2, 64, 64), bf16)
    qd = rnd((1, 4, 64), bf16)
    calls = []
    for bad in (off, ragged):
        calls += [lambda bad=bad: FA.flash_attention_bhsd_cuda(
                      bad(1, 4, 64, 64), kv, kv),
                  lambda bad=bad: FA.flash_attention_bhsd_cuda(
                      q, bad(1, 2, 64, 64), kv),
                  lambda bad=bad: DA.decode_attention_bhd_cuda(
                      bad(1, 4, 64), kv, kv, 10),
                  lambda bad=bad: DA.decode_attention_bhd_cuda(
                      qd, kv, bad(1, 2, 64, 64), 10)]
    for call in calls:
        try:
            call()
        except ValueError as e:
            check("16-byte" in str(e), f"unaligned view: {e}")
        else:
            fail("an unaligned bf16 view was not refused")
    log(f"[kernels] attention: {len(calls)} unaligned bf16 views refused")


SERVE_SWAP_SPANS = ("ckpt/save", "ckpt/materialize", "ckpt/encode",
                    "ckpt/upload", "ckpt/manifest", "ckpt/commit")
SERVE_RESTORE_SPANS = ("ckpt/restore", "restore/plan", "restore/fetch_decode",
                       "restore/assemble")


def zero_launches():
    from repro_torch.kernels import decode_attention, flash_attention, qsnap
    from repro_torch.models.layers import WINDOW_REF_DECODES
    for counts in (qsnap.LAUNCHES, flash_attention.LAUNCHES,
                   decode_attention.LAUNCHES, WINDOW_REF_DECODES):
        for k in counts:
            counts[k] = 0


def read_launches():
    from repro_torch.kernels import decode_attention, flash_attention, qsnap
    from repro_torch.models.layers import WINDOW_REF_DECODES
    return {**qsnap.LAUNCHES, **flash_attention.LAUNCHES,
            **decode_attention.LAUNCHES,
            "window_ref_decodes": WINDOW_REF_DECODES["attention_ref"]}


def serve_phase(torch, np, dev, cfg):
    """Phase 4: the serving path at full width, counted, then suspended
    mid-generation and resumed; returns its launch counts and the
    uninterrupted token stream."""
    from repro_torch.ckpt import AsyncCheckpointer, InMemoryStore, restore
    from repro_torch.configs import reduced
    from repro_torch.models.model import build_model
    from repro_torch.obs.trace import tracer
    from repro_torch.serve.engine import Engine, ServeApp

    model = build_model(cfg)
    # drawn on the card, as ServeApp draws its params
    engine = Engine(model, model.init(torch.Generator(dev).manual_seed(0),
                                      dev), cache_len=S_CACHE)
    prompt = np.random.Generator(np.random.PCG64(0)).integers(
        0, cfg.vocab_size, (S_BATCH, S_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(prompt).to(dev)}
    log(f"[serve] {cfg.name} {cfg.dtype}: batch {S_BATCH} x prompt "
        f"{S_PROMPT}, {S_TOKENS} new tokens, cache {S_CACHE} slots")
    engine.generate(batch, 2)         # warm the libraries; not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(batch, S_TOKENS).cpu().numpy()
    gen_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_layers = cfg.n_layers
    check(launches["flash_attention"] == n_layers,
          f"flash launches {launches['flash_attention']} != {n_layers}")
    check(launches["decode_attention"] == n_layers * (S_TOKENS - 1),
          f"decode launches {launches['decode_attention']} != "
          f"{n_layers} x {S_TOKENS - 1}")
    check(launches["window_ref_decodes"] == 0 and launches["quantize"] == 0,
          f"serving ran other attention or codec paths: {launches}")
    check(tokens.shape == (S_BATCH, S_TOKENS) and tokens.dtype == np.int32
          and 0 <= tokens.min() and tokens.max() < model.vocab_padded,
          f"tokens {tokens.shape} {tokens.dtype} out of range")
    log(f"[serve] launches: flash {launches['flash_attention']} "
        f"(= {n_layers} layers x 1 prefill), decode "
        f"{launches['decode_attention']} (= {n_layers} x {S_TOKENS - 1} "
        f"steps); generate {gen_s:.3f} s, "
        f"{S_BATCH * S_TOKENS / gen_s:.1f} tokens/s; peak memory "
        f"{peak_gb:.2f} GB")

    # prefill and decode steps one by one, each ended by a sync
    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    token = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step_ms, stepped = [], [token]
    for i in range(1, 33):
        t0 = time.perf_counter()
        logits, cache = engine.decode(cache, token, S_PROMPT + i - 1)
        token = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        stepped.append(token)
    check(np.array_equal(torch.cat(stepped, 1).cpu().numpy(),
                         tokens[:, :33]), "step-by-step tokens differ")
    decode_ms = statistics.median(step_ms)
    log(f"[serve] prefill {prefill_ms:.2f} ms; decode step median "
        f"{decode_ms:.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}); {S_BATCH / decode_ms * 1e3:.1f} tokens/s "
        f"in decode")
    prof = profile_steps(torch, lambda: engine.decode(
        cache, token, S_PROMPT + 32)[0].argmax(-1).cpu(), reps=4)
    del cache, logits

    def app(token_delay_s=0.0):
        return ServeApp(cfg, batch=S_BATCH, prompt_len=S_PROMPT,
                        n_tokens=S_TOKENS, cache_len=S_CACHE, device=dev,
                        token_delay_s=token_delay_s)

    want = run_app(app()).checkpoint_state()["tokens_out"]
    check(np.array_equal(want, tokens), "ServeApp stream != Engine.generate")
    # a pause between tokens, as tests/test_serve.py gives its suspended
    # job: a decode loop that never pauses re-takes its lock before a
    # waiting capture gets it
    live = app(token_delay_s=0.05)
    live.start(None, None)
    while live.generated < 4:
        check(live._thread.is_alive(), "serving thread died")
        time.sleep(0.001)
    tracer().reset()
    handle = live.snapshot_async()
    stall_us = live.ckpt_stalls[-1] * 1e6
    live.stop()
    check(handle.step < S_TOKENS, f"snapshot at {handle.step} not "
          f"mid-generation")
    store = InMemoryStore()
    ck = AsyncCheckpointer(store, "serve", codec="raw")
    t0 = time.perf_counter()
    ck.save(handle.step, handle)
    ck.wait()
    swap_s = time.perf_counter() - t0
    ck.close()
    swap_split = span_split(SERVE_SWAP_SPANS)
    tracer().reset()
    t0 = time.perf_counter()
    state, man = restore(store, "serve", device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_split = span_split(SERVE_RESTORE_SPANS)
    image_bytes = sum(c.nbytes for li in man.leaves.values()
                      for c in li.chunks)
    got = run_app(app(), state).checkpoint_state()["tokens_out"]
    check(np.array_equal(got, want),
          "resumed token stream differs from the uninterrupted one")
    log(f"[serve] suspended at token {handle.step}: capture stall "
        f"{stall_us:.1f} us; swap-out (lossless, {image_bytes:,} bytes) "
        f"{swap_s:.3f} s; restore on the card {restore_s:.3f} s; resumed "
        f"{S_BATCH} x {S_TOKENS} tokens equal the uninterrupted run bit "
        f"for bit")
    log_split("serve swap-out", swap_split)
    log_split("serve restore", restore_split)
    check(set(swap_split) == set(SERVE_SWAP_SPANS)
          and set(restore_split) == set(SERVE_RESTORE_SPANS),
          f"spans missing: {set(SERVE_SWAP_SPANS) - set(swap_split)} "
          f"{set(SERVE_RESTORE_SPANS) - set(restore_split)}")
    del engine, state

    # reference on a small input: kernels against the oracles on the card
    small = dataclasses.replace(reduced(cfg), dtype="float32")
    sm = build_model(small)
    sp = sm.init(torch.Generator().manual_seed(0), dev)
    toks = torch.from_numpy(np.random.Generator(np.random.PCG64(1)).integers(
        0, small.vocab_size, (2, 16)).astype(np.int32)).to(dev)
    runs = {}
    for impl in (None, "ref"):
        logits, c = sm.prefill(sp, {"tokens": toks}, cache_len=25, impl=impl)
        seq = [logits]
        for i in range(8):
            logits, c = sm.decode_step(sp, c, torch.argmax(
                logits, -1)[:, None], 16 + i, impl=impl)
            seq.append(logits)
        runs[impl] = torch.stack(seq)
    e = float((runs[None] - runs["ref"]).abs().max())
    check(torch.allclose(runs[None], runs["ref"], rtol=1e-4, atol=1e-4)
          and torch.equal(runs[None].argmax(-1), runs["ref"].argmax(-1)),
          f"reduced f32 serving: kernels vs oracles max error {e}")
    log(f"[serve] reduced f32 model, prefill + 8 decode steps: logits "
        f"through the kernels within {e:.3g} of the oracles (impl='ref') "
        f"on the card, greedy tokens equal")
    log_profile("decode step", prof)
    return launches, tokens


def wait_until(cond, what: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.001)


def service_phase(torch, np, dev, cfg, trainer, straight_losses, want):
    """Phase 5: the trainer and the server as CACS jobs on the card,
    suspended and resumed through ``CACSService``; returns the launch
    counts of the int8 training job and of the serving job."""
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                  CoordState)
    from repro_torch.obs.trace import tracer
    from repro_torch.serve.engine import ServeApp
    from repro_torch.tree import tree_leaves

    svc = CACSService({"snooze": SnoozeBackend(4)},
                      {"default": InMemoryStore()})

    def submit(name, factory, swap_codec):
        cid = svc.submit(ASR(
            name=name, n_vms=1, backend="snooze", app_factory=factory,
            policy=CheckpointPolicy(period_s=0, codec="raw",
                                    swap_codec=swap_codec)))
        return cid, svc.wait_for_state(cid, CoordState.RUNNING, 300)

    def resume(cid):
        t0 = time.perf_counter()
        svc.apps.resume(cid)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        coord = svc.db.get(cid)
        check(coord.state == CoordState.RUNNING,
              f"resume of {cid} ended {coord.state.value}: {coord.error}")
        return dt

    n_steps = 24          # long enough to be running at the suspend
    log(f"[service] CACSService over a Snooze backend, one VM a job: "
        f"{cfg.name} trainer (batch {BATCH} x seq {SEQ}, {n_steps} steps, "
        f"swap_codec int8), a lossless trainer, a ServeApp")
    try:
        # 1. int8 swap-out through the service
        zero_launches()
        cid, coord = submit("train-int8", lambda: trainer(n_steps), "int8")
        app = coord.app
        wait_until(lambda: app.current_step >= 2, "two steps")
        ck_step = svc.apps.checkpoint_now(cid)           # lossless image
        n_float = sum(1 for t in tree_leaves(app.checkpoint_state()["state"])
                      if t.is_floating_point())
        tracer().reset()
        t0 = time.perf_counter()
        svc.apps.suspend(cid)
        suspend_s = time.perf_counter() - t0
        stall_us = app.ckpt_stalls[-1] * 1e6
        swap_split = span_split(SWAP_SPANS)
        check(svc.db.get(cid).state == CoordState.SUSPENDED, "not suspended")
        tracer().reset()
        resume_s = resume(cid)
        restore_split = span_split(RESTORE_SPANS)
        train_launches = read_launches()
        codecs = [svc.get_checkpoint(cid, s)["codec"]
                  for s in (ck_step, ck_step + 1)]
        check(codecs == ["raw", "int8"], f"image codecs {codecs}")
        check(train_launches["quantize"] == n_float,
              f"suspend: quantize launches {train_launches['quantize']} != "
              f"{n_float} float leaves")
        check(train_launches["dequantize"] == n_float,
              f"resume: dequantize launches {train_launches['dequantize']} "
              f"!= {n_float} float leaves")
        check(train_launches["flash_attention"]
              == train_launches["decode_attention"] == 0,
              "training ran an attention kernel")
        # the same load the resume made: every leaf lands on the card
        restored = svc.ckpt.load(coord, ck_step + 1)
        for t in tree_leaves(restored["state"]):
            check(t.device.type == "cuda" and bool(
                torch.isfinite(t.float()).all()),
                "restored leaf not on cuda or not finite")
        check(restored["data"]["step"] >= 2, "image cut before two steps")
        del restored
        wait_until(app.is_done, "the resumed job to finish")
        check(app.restarts == 1 and app.current_step == n_steps
              and len(app.losses) > n_steps - 1
              and all(np.isfinite(app.losses)),
              f"resumed job: restarts {app.restarts}, step "
              f"{app.current_step}, losses {app.losses}")
        log(f"[service] int8 job: images {ck_step} raw, {ck_step + 1} int8; "
            f"launches over submit..resume: quantize "
            f"{train_launches['quantize']}, dequantize "
            f"{train_launches['dequantize']} (= {n_float} float leaves); "
            f"restored leaves on cuda and finite; resumed to step "
            f"{app.current_step}, final loss {app.losses[-1]:.4f}")
        log(f"[service] int8 job: capture stall {stall_us:.1f} us; suspend "
            f"call {suspend_s:.3f} s; resume call {resume_s:.3f} s")
        log_split("service suspend", swap_split)
        log_split("service resume", restore_split)
        check(set(swap_split) == set(SWAP_SPANS)
              and set(restore_split) == set(RESTORE_SPANS),
              f"spans missing: {set(SWAP_SPANS) - set(swap_split)} "
              f"{set(RESTORE_SPANS) - set(restore_split)}")
        svc.delete_coordinator(cid)
        del app, coord

        # 2. the lossless contract through the service
        total = len(straight_losses)
        cid, coord = submit("train-raw", lambda: trainer(total), None)
        app = coord.app
        wait_until(lambda: app.current_step >= KSTEPS, f"step {KSTEPS}")
        svc.apps.suspend(cid)
        before = len(app.losses)
        raw_resume_s = resume(cid)
        wait_until(app.is_done, "the lossless job to finish")
        resumed = app.losses[before:]
        cut = total - len(resumed)
        check(KSTEPS <= cut < total, f"suspended at step {cut}")
        check(svc.ckpt.load(coord)["data"]["step"] == cut,
              "image step != resumed step")
        check(app.losses[:cut] == straight_losses[:cut]
              and resumed == straight_losses[cut:],
              f"service resume diverged: {app.losses[:cut]} + {resumed} vs "
              f"{straight_losses}")
        log(f"[service] lossless job suspended at step {cut} and resumed "
            f"({raw_resume_s:.3f} s): losses {resumed} equal the "
            f"uninterrupted run's bit for bit")
        svc.delete_coordinator(cid)
        del app, coord

        # 3. managed serving
        zero_launches()
        cid, coord = submit("serve", lambda: ServeApp(
            cfg, batch=S_BATCH, prompt_len=S_PROMPT, n_tokens=S_TOKENS,
            cache_len=S_CACHE, device=dev, token_delay_s=0.05), None)
        app = coord.app
        wait_until(lambda: app.generated >= 4, "four tokens")
        t0 = time.perf_counter()
        svc.apps.suspend(cid)
        serve_suspend_s = time.perf_counter() - t0
        serve_stall_us = app.ckpt_stalls[-1] * 1e6
        app.token_delay_s = 0.0              # the resumed stream unpaced
        serve_resume_s = resume(cid)
        t0 = time.perf_counter()
        wait_until(app.is_done, "the resumed server to finish", 600)
        gen_s = time.perf_counter() - t0
        serve_launches = read_launches()
        cut = svc.ckpt.load(coord)["generated"]
        got = app.checkpoint_state()["tokens_out"]
        check(np.array_equal(got, want),
              "managed serving: resumed tokens differ from phase 4's stream")
        n_layers = cfg.n_layers
        check(serve_launches["flash_attention"] == n_layers,
              f"managed serving: flash launches "
              f"{serve_launches['flash_attention']} != {n_layers}")
        check(serve_launches["decode_attention"] % n_layers == 0
              and serve_launches["decode_attention"]
              >= n_layers * (S_TOKENS - 1),
              f"managed serving: decode launches "
              f"{serve_launches['decode_attention']}")
        check(app.restarts == 1 and 4 <= cut < S_TOKENS,
              f"managed serving: restarts {app.restarts}, cut at {cut}")
        log(f"[service] ServeApp suspended at token {cut}: capture stall "
            f"{serve_stall_us:.1f} us; suspend call {serve_suspend_s:.3f} s;"
            f" resume call {serve_resume_s:.3f} s; resumed {S_TOKENS - cut} "
            f"tokens x {S_BATCH} in {gen_s:.3f} s "
            f"({S_BATCH * (S_TOKENS - cut) / gen_s:.1f} tokens/s, unpaced); "
            f"{S_BATCH} x {S_TOKENS} tokens equal phase 4's stream")
        log(f"[service] ServeApp launches: flash "
            f"{serve_launches['flash_attention']} (one prefill), decode "
            f"{serve_launches['decode_attention']} (= {n_layers} x "
            f"{serve_launches['decode_attention'] // n_layers} steps, those "
            f"decoded while the swap-out was written included)")
        svc.delete_coordinator(cid)
    finally:
        svc.shutdown()
    return train_launches, serve_launches


def held_bytes(torch, tree) -> int:
    """Bytes of the CUDA tensors in ``tree``: what the job holds on the
    card."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda")


def check_on_card(torch, tree, what: str) -> None:
    from repro_torch.tree import tree_leaves
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            check(t.device.type == "cuda" and bool(
                torch.isfinite(t.float()).all()),
                f"{what}: a restored leaf is not on cuda or not finite")


def log_history(what: str, t0: float, coords) -> None:
    """The state transitions of ``coords`` after ``t0`` (the wall clock the
    coordinator histories are stamped with), as seconds since ``t0``."""
    rows = sorted((t - t0, c.asr.name, state) for c in coords
                  for t, state, *_ in c.history if t >= t0)
    log(f"[sched] {what}: " + "; ".join(
        f"+{dt:.3f} s {name} {state}" for dt, name, state in rows))


def preempt_phase(torch, np, dev, cfg, trainer, want):
    """Phase 6 (a): the global scheduler on a one-host Snooze cloud swaps a
    low-priority int8 trainer off the card for a high-priority server, and
    swaps it back when the server is done; returns the launch counts."""
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                  CoordState, GlobalScheduler)
    from repro_torch.obs.trace import tracer
    from repro_torch.serve.engine import ServeApp
    from repro_torch.tree import tree_leaves

    svc = CACSService({"snooze": SnoozeBackend(1)},
                      {"default": InMemoryStore()})
    sched = GlobalScheduler(svc)
    svc.attach_scheduler(sched)
    sched.start()
    n_layers = cfg.n_layers
    log(f"[sched] preemption: GlobalScheduler over a one-host Snooze cloud; "
        f"a priority-1 {cfg.name} trainer ({PREEMPT_STEPS} steps, "
        f"swap_codec int8), then a priority-9 ServeApp (batch {S_BATCH}, "
        f"prompt {S_PROMPT}, {S_TOKENS} tokens)")
    try:
        zero_launches()
        low = sched.submit(ASR(
            name="train-low", n_vms=1, backend="snooze", priority=1,
            app_factory=lambda: trainer(PREEMPT_STEPS),
            policy=CheckpointPolicy(period_s=0, codec="raw",
                                    swap_codec="int8")))
        coord = svc.wait_for_state(low, CoordState.RUNNING, 300)
        app = coord.app
        wait_until(lambda: app.current_step >= 2, "two steps")
        n_float = sum(1 for t in tree_leaves(app.checkpoint_state()["state"])
                      if t.is_floating_point())
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        tracer().reset()
        t0, stamp = time.perf_counter(), time.time()
        hi = sched.submit(ASR(
            name="serve-hi", n_vms=1, backend="snooze", priority=9,
            app_factory=lambda: ServeApp(
                cfg, batch=S_BATCH, prompt_len=S_PROMPT, n_tokens=S_TOKENS,
                cache_len=S_CACHE, device=dev),
            policy=CheckpointPolicy(period_s=0, codec="raw")))
        server = svc.wait_for_state(hi, CoordState.RUNNING, 300)
        preempt_s = time.perf_counter() - t0
        log_history("preemption", stamp, (coord, server))
        swap_split = span_split(SWAP_SPANS)
        check(coord.state == CoordState.SUSPENDED,
              f"the trainer was not swapped out: {coord.state.value}")
        cut = app.current_step
        held_out = held_bytes(torch, app.checkpoint_state()["state"])
        torch.cuda.synchronize()
        mem_out = torch.cuda.memory_allocated()
        wait_until(server.app.is_done, "the server's tokens", 600)
        got = server.app.checkpoint_state()["tokens_out"]
        check(np.array_equal(got, want),
              "the high-priority server's tokens differ from phase 4's")
        mid = read_launches()
        check(mid["quantize"] == n_float and mid["dequantize"] == 0,
              f"preemption: quantize {mid['quantize']}, dequantize "
              f"{mid['dequantize']}; want {n_float} and 0")
        check(mid["flash_attention"] == n_layers
              and mid["decode_attention"] == n_layers * (S_TOKENS - 1),
              f"server: flash {mid['flash_attention']}, decode "
              f"{mid['decode_attention']}; want {n_layers} and "
              f"{n_layers} x {S_TOKENS - 1} (none in the swap-out)")
        tracer().reset()
        t0, stamp = time.perf_counter(), time.time()
        svc.delete_coordinator(hi)        # the finished server frees its VM
        wait_until(lambda: coord.state == CoordState.RUNNING
                   and sched.resumes == 1, "the scheduler's resume")
        back_s = time.perf_counter() - t0
        log_history("return", stamp, (coord, server))
        restore_split = span_split(RESTORE_SPANS)
        launches = read_launches()
        check(launches["dequantize"] == n_float and launches["quantize"]
              == n_float and launches["flash_attention"] == n_layers,
              f"resume: dequantize {launches['dequantize']} != {n_float}")
        torch.cuda.synchronize()
        mem_back = torch.cuda.memory_allocated()
        decisions = [(op, job) for _, op, job, *_ in sched.decision_trace()]
        check(decisions == [("submit", "train-low"), ("start", "train-low"),
                            ("submit", "serve-hi"), ("preempt", "train-low"),
                            ("start", "serve-hi"), ("resume", "train-low")],
              f"decision trace {decisions}")
        check(sched.preemptions == 1 and sched.aborted_preemptions == 0,
              f"scheduler stats {sched.stats()}")
        image = svc.ckpt.latest(coord)
        check(svc.get_checkpoint(low, image)["codec"] == "int8",
              "the swap-out image is not int8")
        restored = svc.ckpt.load(coord, image)  # the resume's load again
        check_on_card(torch, restored["state"], "preemption resume")
        del restored
        wait_until(app.is_done, "the resumed trainer to finish", 600)
        check(app.restarts == 1 and app.current_step == PREEMPT_STEPS
              and all(np.isfinite(app.losses)),
              f"resumed trainer: restarts {app.restarts}, step "
              f"{app.current_step}, losses {app.losses}")
    finally:
        sched.stop()
        svc.shutdown()
    log(f"[sched] decision trace: " + ", ".join(
        f"{op} {job}" for op, job in decisions))
    log(f"[sched] preemption at step {cut}: server submit -> RUNNING "
        f"{preempt_s:.3f} s (holds the trainer's int8 swap-out, "
        f"{mid['quantize']} quantize launches, no attention launch); server "
        f"{S_BATCH} x {S_TOKENS} tokens equal phase 4's (flash "
        f"{mid['flash_attention']}, decode {mid['decode_attention']}); "
        f"server done -> trainer RUNNING {back_s:.3f} s "
        f"({launches['dequantize']} dequantize launches, leaves on cuda and "
        f"finite); trainer ran to step {app.current_step}, restarts "
        f"{app.restarts}, final loss {app.losses[-1]:.4f}")
    log(f"[sched] memory_allocated: before the preemption {mem_before:,} B; "
        f"trainer swapped out, server running {mem_out:,} B; after the "
        f"resume {mem_back:,} B; the swapped-out trainer still references "
        f"{held_out:,} B of state on the card")
    log_split("sched preemption swap-out", swap_split)
    log_split("sched resume", restore_split)
    check(set(swap_split) == set(SWAP_SPANS)
          and set(restore_split) == set(RESTORE_SPANS),
          f"spans missing: {set(SWAP_SPANS) - set(swap_split)} "
          f"{set(RESTORE_SPANS) - set(restore_split)}")
    return launches


def failover_phase(torch, np, dev, cfg, trainer, straight_losses):
    """Phase 6 (b): a lossless trainer on a Snooze cloud, its images
    replicated to an OpenStack standby; a whole-cloud outage of the
    primary fails it over to the standby, which restores it on the card
    and finishes the run with the uninterrupted losses."""
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import OpenStackBackend, SnoozeBackend
    from repro_torch.core import (ASR, CACSService, ChaosController,
                                  CheckpointPolicy, CoordState,
                                  FailoverController, FaultEvent, FaultKind,
                                  FaultSchedule, ImageReplicator,
                                  ReplicationPolicy, StandbyTarget)

    snooze, ostack = SnoozeBackend(2), OpenStackBackend(2)
    store_a, store_b = InMemoryStore(), InMemoryStore()
    primary = CACSService({"snooze": snooze}, {"default": store_a})
    standby = CACSService({"openstack": ostack}, {"default": store_b})
    rep = ImageReplicator(primary)
    rep.add_target(StandbyTarget("openstack", store=store_b, service=standby,
                                 backend="openstack"))
    primary.attach_replicator(rep)
    ctrl = FailoverController(primary, rep)
    total = len(straight_losses)
    log(f"[sched] failover: a lossless {cfg.name} trainer ({total} steps) on "
        f"Snooze (store A), replicated to an OpenStack standby (store B)")
    try:
        cid = primary.submit(ASR(
            name="train-failover", n_vms=1, backend="snooze",
            app_factory=lambda: trainer(total),
            policy=CheckpointPolicy(period_s=0, codec="raw")))
        coord = primary.wait_for_state(cid, CoordState.RUNNING, 300)
        rep.watch(cid, ReplicationPolicy(targets=("openstack",)))
        rep.start()
        ctrl.start()
        wait_until(lambda: coord.app.current_step >= 2, "two steps")
        t0 = time.perf_counter()
        step = primary.trigger_checkpoint(cid)
        pair = lambda: primary.replication_stats(cid)["targets"]["openstack"]
        wait_until(lambda: pair()["last_step"] == step
                   and pair()["lag_images"] == 0, "the image replicated")
        lag_s = time.perf_counter() - t0
        shipped = pair()
        puts = store_b.put_count
        schedule = FaultSchedule(seed=0, events=[
            FaultEvent(at_s=0.0, kind=FaultKind.CLOUD_OUTAGE)])
        t0 = time.perf_counter()
        outcomes = ChaosController(primary, cid, snooze, schedule,
                                   failover=ctrl,
                                   settle_timeout_s=300).run()
        outage_s = time.perf_counter() - t0
        res = ctrl.results.get(cid)
        check(res is not None and res.ok and all(o.ok for o in outcomes),
              f"failover: {res} {[o.trace_key() for o in outcomes]}")
        check(res.target == "openstack" and res.step == step
              and res.chunks_reuploaded == 0 and store_b.put_count == puts,
              f"failover from step {res.step} (want {step}), "
              f"{res.chunks_reuploaded} chunks re-uploaded, "
              f"{store_b.put_count - puts} objects written to the standby")
        dst = standby.db.get(res.dst_id)
        check(dst.state == CoordState.RUNNING and dst.app.restarts == 1
              and dst.asr.backend == "openstack",
              f"standby job {dst.state.value}, restarts {dst.app.restarts}")
        check(coord.state == CoordState.TERMINATED,
              f"the primary ended {coord.state.value}")
        restored = standby.ckpt.load(dst, res.step)
        check_on_card(torch, restored["state"], "failover restore")
        k = restored["data"]["step"]
        del restored
        wait_until(dst.app.is_done, "the standby trainer to finish", 600)
        check(k >= 2 and dst.app.losses == straight_losses[k:],
              f"failover resume diverged at step {k}: {dst.app.losses} vs "
              f"{straight_losses[k:]}")
    finally:
        ctrl.stop()
        rep.stop()
        standby.shutdown()
        primary.shutdown()
    log(f"[sched] failover: image {step} (step {k}) replicated in "
        f"{lag_s:.3f} s after its save was asked for "
        f"({shipped['bytes_copied']:,} bytes in {shipped['chunks_copied']} "
        f"chunks shipped, rpo "
        f"{shipped['rpo_s']:.3f} s); outage -> standby RUNNING "
        f"{outage_s:.3f} s; detection {res.detection_s:.3f} s, MTTR "
        f"{res.mttr_s:.3f} s, standby restart {res.restart_s:.3f} s; 0 chunks "
        f"re-uploaded; leaves on cuda; losses after step {k} "
        f"{dst.app.losses} equal the uninterrupted run's bit for bit")


def fleet_phase(torch, np, dev, cfg, want):
    """Phase 6 (c): a FleetController on the scheduler cold-starts two
    ServeApp replicas from a seed image by prefix adoption, parks one
    mid-generation and unparks it; returns the launch counts."""
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import CACSService, CoordState, GlobalScheduler
    from repro_torch.serve import FleetController, FleetPolicy
    from repro_torch.serve.engine import ServeApp

    svc = CACSService({"snooze": SnoozeBackend(2)},
                      {"default": InMemoryStore()})
    sched = GlobalScheduler(svc)          # synchronous passes: no loop
    svc.attach_scheduler(sched)
    fleet = FleetController(
        svc, sched, name=cfg.name,
        replica_factory=lambda: ServeApp(
            cfg, batch=S_BATCH, prompt_len=S_PROMPT, n_tokens=FLEET_TOKENS,
            cache_len=S_CACHE, device=dev, token_delay_s=0.05),
        policy=FleetPolicy(min_replicas=1, max_replicas=2,
                           scale_in_idle_s=0.0), backend="snooze")
    n_layers = cfg.n_layers
    log(f"[sched] fleet: two {cfg.name} ServeApp replicas (batch {S_BATCH}, "
        f"prompt {S_PROMPT}, {FLEET_TOKENS} tokens, paced) on a two-host "
        f"Snooze cloud, seeded after {FLEET_SEED} tokens")
    try:
        zero_launches()
        seed = run_app(ServeApp(cfg, batch=S_BATCH, prompt_len=S_PROMPT,
                                n_tokens=FLEET_SEED, cache_len=S_CACHE,
                                device=dev)).checkpoint_state()
        fleet.publish_seed(seed, step=seed["generated"])
        store = svc.ckpt.store()
        puts = store.put_count
        t0 = time.perf_counter()
        cids = fleet.scale_out(2)
        fleet.wait_live(cids, timeout=300)
        cold_s = time.perf_counter() - t0
        check(len(cids) == 2 and fleet.coldstart_reuploads == 0
              and store.put_count == puts,
              f"cold start wrote {store.put_count - puts} objects, "
              f"re-uploads {fleet.coldstart_reuploads}")
        coords = [svc.db.get(c) for c in cids]
        for c in coords:
            check(c.app.restarts == 1 and c.app.generated >= FLEET_SEED,
                  f"{c.asr.name} did not restore the seed")
            check_on_card(torch, c.app.checkpoint_state()["params"],
                          f"{c.asr.name} cold start")
        colds = [c.metrics["coldstart_s"] for c in coords]
        wait_until(lambda: coords[0].app.generated >= FLEET_SEED + 2,
                   "two replica tokens")
        t0 = time.perf_counter()
        parked = fleet.scale_in(1, force=True)
        park_s = time.perf_counter() - t0
        check(len(parked) == 1, "scale-in parked nothing")
        pc = svc.db.get(parked[0])
        check(pc.state == CoordState.SUSPENDED
              and pc.metrics.get("fleet_parked") == 1
              and pc.app.generated < FLEET_TOKENS,
              f"park: {pc.state.value} at token {pc.app.generated}")
        cut = svc.ckpt.load(pc)["generated"]
        t0 = time.perf_counter()
        back = fleet.scale_out(1)
        fleet.wait_live(back, timeout=300)
        unpark_s = time.perf_counter() - t0
        check(back == parked and pc.state == CoordState.RUNNING
              and pc.app.restarts == 2, f"unpark: {back} {pc.state.value}")
        for c in coords:
            wait_until(c.app.is_done, f"{c.asr.name} to finish", 600)
            check(np.array_equal(c.app.checkpoint_state()["tokens_out"],
                                 want[:, :FLEET_TOKENS]),
                  f"{c.asr.name}: tokens differ from phase 4's stream")
        launches = read_launches()
        decoded = n_layers * ((FLEET_SEED - 1) + 2 * (FLEET_TOKENS
                                                     - FLEET_SEED))
        check(launches["flash_attention"] == n_layers
              and launches["decode_attention"] % n_layers == 0
              and launches["decode_attention"] >= decoded
              and launches["quantize"] == launches["dequantize"] == 0,
              f"fleet launches {launches}")
        stats = fleet.stats()
        check(stats["parks"] == stats["unparks"] == 1
              and stats["coldstarts"] == 3, f"fleet stats {stats}")
    finally:
        sched.stop()
        svc.shutdown()
    log(f"[sched] fleet: scale_out(2) -> both RUNNING {cold_s:.3f} s "
        f"(cold starts {colds[0]:.3f} s and {colds[1]:.3f} s, 0 objects "
        f"written, leaves on cuda); {pc.asr.name} parked at token {cut}: "
        f"scale_in call {park_s:.3f} s, unpark to RUNNING {unpark_s:.3f} s; "
        f"both replicas' {S_BATCH} x {FLEET_TOKENS} tokens equal phase 4's "
        f"stream; launches flash {launches['flash_attention']} (the seed's "
        f"prefill), decode {launches['decode_attention']} (= {n_layers} x "
        f"{launches['decode_attention'] // n_layers} steps)")
    return launches


def mem_available() -> int:
    """The host's MemAvailable in bytes (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def jamba_phase(torch, np, dev, mem_rate):
    """Phase 7: jamba-v0.1-52b at full width, depth cut to one 8-layer
    period, served through its one attention layer's kernels and its
    Mamba and MoE layers, then a ServeApp suspended mid-generation with its
    KV cache and Mamba state and resumed with the same tokens; returns the
    launch counts of Engine.generate and the attention rows at jamba's
    served shapes."""
    import tempfile
    from repro_torch.ckpt import (AsyncCheckpointer, InMemoryStore,
                                  LocalFSStore, restore)
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.model import build_model
    from repro_torch.obs.trace import tracer
    from repro_torch.serve.engine import Engine, ServeApp
    from repro_torch.tree import leaves_with_path, tree_leaves

    host_free = mem_available()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    model = build_model(cfg)
    kinds = [b.kind for b in model.blocks]
    log(f"[jamba] {cfg.name} {cfg.dtype}: every width published, depth cut "
        f"from {get_config(cfg.name).n_layers} to {cfg.n_layers} layers "
        f"(one period: {kinds.count('attn')} attention, "
        f"{kinds.count('mamba')} Mamba, {kinds.count('moe')} MoE, "
        f"{kinds.count('mlp')} MLP); batch {J_BATCH} x prompt {J_PROMPT}, "
        f"{J_TOKENS} new tokens, cache {J_CACHE} slots; host MemAvailable "
        f"{host_free:,} B")
    mem = [f"at the start {torch.cuda.memory_allocated():,} B"]

    def free(what):
        """Free what was dropped, gc cycles included: one copy of the
        weights at a time."""
        before = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        mem.append(f"{what} {before:,} -> {torch.cuda.memory_allocated():,}"
                   f" B after gc")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    check(n_params == J_PARAMS, f"jamba params {n_params:,} != {J_PARAMS:,}")
    log(f"[jamba] {n_params:,} parameters ({param_bytes:,} B) drawn on the "
        f"card in {init_s:.3f} s")
    engine = Engine(model, params, cache_len=J_CACHE)
    prompt = np.random.Generator(np.random.PCG64(0)).integers(
        0, cfg.vocab_size, (J_BATCH, J_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(prompt).to(dev)}
    engine.generate(batch, 2)          # warm the libraries; not counted
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(batch, J_TOKENS).cpu().numpy()
    gen_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["flash_attention"] == 1,
          f"jamba flash launches {launches['flash_attention']} != 1")
    check(launches["decode_attention"] == J_TOKENS - 1,
          f"jamba decode launches {launches['decode_attention']} != "
          f"{J_TOKENS - 1}")
    check(launches["window_ref_decodes"] == 0 and launches["quantize"] == 0
          and launches["dequantize"] == 0,
          f"jamba serving ran other attention or codec paths: {launches}")
    check(tokens.shape == (J_BATCH, J_TOKENS) and tokens.dtype == np.int32
          and 0 <= tokens.min() and tokens.max() < model.vocab_padded,
          f"jamba tokens {tokens.shape} {tokens.dtype} out of range")
    log(f"[jamba] launches: flash {launches['flash_attention']} (1 attention "
        f"layer x 1 prefill), decode {launches['decode_attention']} (1 x "
        f"{J_TOKENS - 1} steps), none from the Mamba and MoE layers; "
        f"generate {gen_s:.3f} s, {J_BATCH * J_TOKENS / gen_s:.1f} tokens/s")

    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    token = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step_ms, stepped = [], [token]
    for i in range(1, 9):
        t0 = time.perf_counter()
        logits, cache = engine.decode(cache, token, J_PROMPT + i - 1)
        token = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        stepped.append(token)
    check(np.array_equal(torch.cat(stepped, 1).cpu().numpy(), tokens[:, :9]),
          "jamba step-by-step tokens differ")
    decode_ms = statistics.median(step_ms)
    decode_bound_ms = param_bytes / mem_rate * 1e3
    log(f"[jamba] prefill {prefill_ms:.2f} ms; decode step median "
        f"{decode_ms:.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}); every step reads all {param_bytes:,} B of "
        f"weights (each expert runs its capacity slots): bound "
        f"{decode_bound_ms:.2f} ms at {mem_rate / 1e12:.2f} TB/s")
    prof = profile_steps(torch, lambda: engine.decode(
        cache, token, J_PROMPT + 9)[0].argmax(-1).cpu(), reps=4)
    log_profile("jamba decode step", prof)
    del cache, logits, engine, params
    peaks = [torch.cuda.max_memory_allocated()]
    free("Engine dropped")

    rnd = attn_rnd(torch, dev, 2)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"flash": flash_row(torch, FA, rnd, J_BATCH, J_PROMPT, H, Hkv, hd,
                               mem_rate, "jamba"),
            "decode": decode_row(torch, DA, rnd, J_BATCH, J_CACHE, H, Hkv, hd,
                                 mem_rate, "jamba")}
    for name, r in attn.items():
        log_attn_row(name, "jamba", r)

    def app(token_delay_s=0.0):
        return ServeApp(cfg, batch=J_BATCH, prompt_len=J_PROMPT,
                        n_tokens=J_TOKENS, cache_len=J_CACHE, device=dev,
                        token_delay_s=token_delay_s)

    straight = run_app(app())
    want = straight.checkpoint_state()["tokens_out"]
    check(np.array_equal(want, tokens), "jamba ServeApp != Engine.generate")
    del straight
    free("uninterrupted app dropped")
    torch.cuda.reset_peak_memory_stats()
    live = app(token_delay_s=0.05)
    live.start(None, None)
    while live.generated < 4:
        check(live._thread.is_alive(), "jamba serving thread died")
        time.sleep(0.001)
    tracer().reset()
    handle = live.snapshot_async()
    stall_us = live.ckpt_stalls[-1] * 1e6
    live.stop()
    at = handle.step
    check(at < J_TOKENS, f"snapshot at {at} not mid-generation")
    # the host holds the staged image and the store's copy at once
    in_memory = host_free > 2.5 * param_bytes
    tmp = None if in_memory else tempfile.TemporaryDirectory()
    store = InMemoryStore() if in_memory else LocalFSStore(tmp.name)
    ck = AsyncCheckpointer(store, "jamba", codec="raw")
    t0 = time.perf_counter()
    ck.save(at, handle)
    ck.wait()
    swap_s = time.perf_counter() - t0
    ck.close()
    swap_split = span_split(SERVE_SWAP_SPANS)
    del live, handle, ck
    free("suspended app dropped")
    tracer().reset()
    t0 = time.perf_counter()
    state, man = restore(store, "jamba", device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_split = span_split(SERVE_RESTORE_SPANS)
    image_bytes = sum(c.nbytes for li in man.leaves.values()
                      for c in li.chunks)
    del store
    if tmp is not None:
        tmp.cleanup()
    on_card = [(p, t) for p, t in leaves_with_path(
        {k: state[k] for k in ("params", "cache", "last_token")})]
    check(all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
              for _, t in on_card), "jamba: a restored leaf is not on cuda")
    mamba = {p[1:]: t for p, t in on_card
             if p[0] == "cache" and p[1].endswith("_mamba")}
    check(len(mamba) == 2 * kinds.count("mamba") and all(
        t.dtype == (torch.float32 if p[1] == "h" else torch.bfloat16)
        for p, t in mamba.items()),
        "jamba: the Mamba state did not come back as h f32 and conv bf16")
    got = run_app(app(), state).checkpoint_state()["tokens_out"]
    check(np.array_equal(got, want),
          "jamba: resumed token stream differs from the uninterrupted one")
    del state
    peaks.append(torch.cuda.max_memory_allocated())
    log(f"[jamba] ServeApp suspended at token {at}: "
        f"capture stall {stall_us:.1f} us; swap-out (lossless, "
        f"{image_bytes:,} B image, {'in memory' if in_memory else 'on disk'})"
        f" {swap_s:.3f} s; restore on the card {restore_s:.3f} s, every leaf "
        f"on cuda ({len(mamba) // 2} Mamba h f32 + conv); resumed {J_BATCH} x "
        f"{J_TOKENS} tokens equal the uninterrupted run bit for bit; host "
        f"MemAvailable {mem_available():,} B")
    log(f"[jamba] device memory: peak {peaks[0]:,} B serving through the "
        f"Engine, {peaks[1]:,} B through the suspend, restore and resume; "
        f"memory_allocated " + "; ".join(mem))
    log_split("jamba swap-out", swap_split)
    log_split("jamba restore", restore_split)
    torch.cuda.empty_cache()

    # reference on a small input: kernels against the oracles on the card
    small = dataclasses.replace(reduced(cfg), dtype="float32")
    sm = build_model(small)
    sp = sm.init(torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.Generator(np.random.PCG64(1)).integers(
        0, small.vocab_size, (2, 16)).astype(np.int32)).to(dev)
    runs = {}
    for impl in (None, "ref"):
        logits, c = sm.prefill(sp, {"tokens": toks}, cache_len=25, impl=impl)
        seq = [logits]
        for i in range(8):
            logits, c = sm.decode_step(sp, c, torch.argmax(
                logits, -1)[:, None], 16 + i, impl=impl)
            seq.append(logits)
        runs[impl] = torch.stack(seq)
    e = float((runs[None] - runs["ref"]).abs().max())
    check(torch.allclose(runs[None], runs["ref"], rtol=1e-4, atol=1e-4)
          and torch.equal(runs[None].argmax(-1), runs["ref"].argmax(-1)),
          f"reduced f32 jamba: kernels vs oracles max error {e}")
    log(f"[jamba] reduced f32 jamba, prefill + 8 decode steps: logits "
        f"through the kernels within {e:.3g} of the oracles (impl='ref') "
        f"on the card, greedy tokens equal")
    return launches, attn


def family_batch(torch, np, dev, cfg, B, S, seed=0):
    """A serving batch at full width: the prompt tokens (as ``ServeApp``
    draws them from its seed) and, for an enc-dec model, its encoder
    frames or, for a vlm, its patch embeddings, drawn on the card."""
    tokens = np.random.Generator(np.random.PCG64(seed)).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    extra = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
    if extra:
        gen = torch.Generator(dev).manual_seed(seed + 1)
        batch[extra] = (torch.randn(B, cfg.frontend_len, cfg.d_model,
                                    generator=gen, device=dev)
                        * 0.02).to(getattr(torch, cfg.dtype))
    return batch


def serve_family(torch, np, dev, arch):
    """Phase 8, one family: the model at full width drawn on the card and
    served through ``Engine.generate`` with the launch counts zeroed just
    before and read just after; prefill and decode step times; for a model
    with attention, its first-step logits through the kernels against the
    oracles' (impl="ref"). Returns what the caller checks and keeps."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import tree_leaves

    n_params, B, S, n_new, cache_len = P8[arch]
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    got = sum(t.numel() for t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    check(got == n_params, f"{arch} params {got:,} != {n_params:,}")
    batch = family_batch(torch, np, dev, cfg, B, S)
    engine = Engine(model, params, cache_len=cache_len)
    positions = []
    real_decode = engine.decode

    def decode(cache, token, pos):
        positions.append(pos)
        return real_decode(cache, token, pos)
    engine.decode = decode
    engine.generate(batch, 2)          # warm the libraries; not counted
    torch.cuda.synchronize()
    positions.clear()
    zero_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(batch, n_new).cpu().numpy()
    gen_s = time.perf_counter() - t0
    launches = read_launches()
    check(tokens.shape == (B, n_new) and tokens.dtype == np.int32
          and 0 <= tokens.min() and tokens.max() < model.vocab_padded,
          f"{arch} tokens {tokens.shape} {tokens.dtype} out of range")
    check(launches["quantize"] == launches["dequantize"] == 0,
          f"{arch}: serving ran the codec: {launches}")
    kinds = [b.kind for b in model.blocks]
    log(f"[p8] {arch} {cfg.dtype}: {n_params:,} parameters ({param_bytes:,}"
        f" B) drawn on the card in {init_s:.3f} s; {model.n_groups} x "
        f"{kinds} + {model.enc_groups} encoder layers; batch {B} x prompt "
        f"{S}, {n_new} new tokens, cache {cache_len}; generate {gen_s:.3f} "
        f"s ({B * n_new / gen_s:.1f} tokens/s); first decode pos "
        f"{positions[0]}; launches flash {launches['flash_attention']}, "
        f"decode {launches['decode_attention']}, attention_ref decodes "
        f"{launches['window_ref_decodes']}")

    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    token = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step_ms = []
    for i in range(8):
        t0 = time.perf_counter()
        logits, cache = real_decode(cache, token, positions[0] + i)
        token = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[p8] {arch}: prefill {prefill_ms:.2f} ms; decode step median "
        f"{statistics.median(step_ms):.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}); every step reads all {param_bytes:,} B of "
        f"weights")
    log_profile(f"{arch} decode step", profile_steps(
        torch, lambda: real_decode(cache, token, positions[0] + 8)[0]
        .argmax(-1).cpu()))
    out = dict(cfg=cfg, model=model, params=params, batch=batch,
               tokens=tokens, launches=launches, positions=positions,
               cache=cache, peak=torch.cuda.max_memory_allocated())
    del logits, token
    if "attn" in kinds:
        runs = {}
        for impl in (None, "ref"):
            lg, c = model.prefill(params, batch, cache_len=cache_len,
                                  impl=impl)
            tok = runs[None][2] if impl == "ref" else \
                torch.argmax(lg, -1)[:, None].to(torch.int32)
            lg2, c = model.decode_step(params, c, tok, positions[0],
                                       impl=impl)
            runs[impl] = (lg.float(), lg2.float(), tok)
            del c
        rel = [float((a - b).norm() / b.norm())
               for a, b in zip(runs[None][:2], runs["ref"][:2])]
        agree = float((runs[None][0].argmax(-1)
                       == runs["ref"][0].argmax(-1)).float().mean())
        check(max(rel) <= LOGIT_REL_TOL,
              f"{arch}: kernel-path logits vs the oracles' relative error "
              f"{rel} > {LOGIT_REL_TOL}")
        log(f"[p8] {arch}: first-step logits through the kernels against "
            f"impl='ref' (the plain versions): relative L2 error prefill "
            f"{rel[0]:.3g}, first decode {rel[1]:.3g} (<= {LOGIT_REL_TOL}); "
            f"greedy first tokens agree on {agree:.3f} of the batch")
        del runs
    return out


def free_card(torch, what: str) -> None:
    """Free a dropped model, gc cycles included, before the next one."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[p8] {what} dropped: memory_allocated {before:,} -> "
        f"{torch.cuda.memory_allocated():,} B")


def families_phase(torch, np, dev, mem_rate):
    """Phase 8: xlstm-125m, seamless-m4t-medium, internvl2-2b and
    gemma3-12b at every published width and depth, one after the other
    (each freed before the next); the xLSTM server suspended and resumed
    through CACSService; the attention kernels at gemma3's and seamless's
    served shapes. Returns each model's launch counts and the attention
    rows."""
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                  CoordState)
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.engine import ServeApp
    from repro_torch.tree import leaves_with_path

    t_phase = time.perf_counter()
    launches, attn = {}, {}

    # (a) xlstm-125m: no attention kernel; its recurrent state suspended
    arch = "xlstm-125m"
    r = serve_family(torch, np, dev, arch)
    n_params, B, S, n_new, cache_len = P8[arch]
    la = launches[arch] = r["launches"]
    check(la["flash_attention"] == la["decode_attention"]
          == la["window_ref_decodes"] == 0,
          f"xlstm launched attention: {la}")
    want, cfg = r["tokens"], r["cfg"]
    del r
    free_card(torch, "xlstm Engine")
    svc = CACSService({"snooze": SnoozeBackend(1)},
                      {"default": InMemoryStore()})
    try:
        cid = svc.submit(ASR(
            name="serve-xlstm", n_vms=1, backend="snooze",
            app_factory=lambda: ServeApp(
                cfg, batch=B, prompt_len=S, n_tokens=n_new,
                cache_len=cache_len, device=dev, token_delay_s=0.05),
            policy=CheckpointPolicy(period_s=0, codec="raw")))
        coord = svc.wait_for_state(cid, CoordState.RUNNING, 300)
        app = coord.app
        wait_until(lambda: app.generated >= 4, "four xlstm tokens")
        t0 = time.perf_counter()
        svc.apps.suspend(cid)
        suspend_s = time.perf_counter() - t0
        stall_us = app.ckpt_stalls[-1] * 1e6
        app.token_delay_s = 0.0
        t0 = time.perf_counter()
        svc.apps.resume(cid)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        check(svc.db.get(cid).state == CoordState.RUNNING,
              "xlstm server not running after its resume")
        wait_until(app.is_done, "the resumed xlstm server to finish")
        check(np.array_equal(app.checkpoint_state()["tokens_out"], want),
              "xlstm: resumed tokens differ from Engine.generate's")
        image = svc.ckpt.load(coord)
        cut = image["generated"]
        leaves = leaves_with_path({k: image[k] for k in
                                   ("params", "cache", "last_token")})
        check(all(isinstance(t, torch.Tensor) and t.device == dev
                  for _, t in leaves), "xlstm: a restored leaf is off cuda")
        states = {p[1:]: t for p, t in leaves if p[0] == "cache"}
        check(all(t.dtype == torch.float32 for p, t in states.items()
                  if p[1] != "conv")
              and sorted({p[1] for p in states}) == [
                  "C", "c", "conv", "h", "m", "n"],
              "xlstm: the recurrent states did not come back in f32")
        C = states[("l0_mlstm", "C")]
        check((tuple(C.shape), C.numel() * C.element_size()) == XLSTM_C,
              f"xlstm: mLSTM C {tuple(C.shape)}")
        state_bytes = sum(t.numel() * t.element_size()
                          for t in states.values())
        check(app.restarts == 1 and 4 <= cut < n_new,
              f"xlstm server: restarts {app.restarts}, cut at {cut}")
        log(f"[p8] xlstm ServeApp suspended through CACSService at token "
            f"{cut}: capture stall {stall_us:.1f} us; suspend call "
            f"{suspend_s:.3f} s; resume call {resume_s:.3f} s; its image "
            f"holds the mLSTM C ({C.numel() * C.element_size():,} B), n, "
            f"conv and the sLSTM c, n, h, m ({state_bytes:,} B of state), "
            f"every leaf on cuda, states f32; resumed {B} x {n_new} tokens "
            f"equal Engine.generate's bit for bit")
        svc.delete_coordinator(cid)
        del app, coord, image, leaves, states, C
    finally:
        svc.shutdown()
    free_card(torch, "xlstm server")

    # (b) seamless-m4t-medium: encoder, self- and cross-attention kernels
    arch = "seamless-m4t-medium"
    r = serve_family(torch, np, dev, arch)
    n_params, B, S, n_new, cache_len = P8[arch]
    la = launches[arch] = r["launches"]
    n_dec, n_enc = r["cfg"].n_layers, r["cfg"].encoder.n_layers
    check(la["flash_attention"] == n_enc + 2 * n_dec
          == SEAMLESS_LAUNCHES[0],
          f"seamless flash launches {la['flash_attention']} != "
          f"{SEAMLESS_LAUNCHES[0]}")
    check(la["decode_attention"] == 2 * n_dec * (n_new - 1)
          == SEAMLESS_LAUNCHES[1] * (n_new - 1),
          f"seamless decode launches {la['decode_attention']} != "
          f"{SEAMLESS_LAUNCHES[1]} x {n_new - 1}")
    check(la["window_ref_decodes"] == 0, "seamless ran attention_ref")
    check(r["positions"][0] == S, f"seamless first pos {r['positions'][0]}")
    memory = sum(t.numel() * t.element_size()
                 for name, c in r["cache"].items() if "xattn" in name
                 for t in c.values())
    check(memory == SEAMLESS_MEMORY_BYTES,
          f"seamless mk/mv {memory:,} B != {SEAMLESS_MEMORY_BYTES:,}")
    log(f"[p8] seamless: flash {la['flash_attention']} a prefill ({n_enc} "
        f"encoder, {n_dec} self, {n_dec} cross), decode "
        f"{la['decode_attention'] // (n_new - 1)} a step ({n_dec} self, "
        f"{n_dec} cross at pos {r['batch']['frames'].shape[1] - 1}); "
        f"cross-attention memory mk/mv {memory:,} B")
    del r
    free_card(torch, "seamless")
    rnd = attn_rnd(torch, dev, 3)
    attn["seamless_flash"] = flash_row(torch, FA, rnd, 4, 4096, 16, 16, 64,
                                       mem_rate, "seamless encoder",
                                       causal=False)
    attn["seamless_decode"] = decode_row(torch, DA, rnd, 4, 4096, 16, 16,
                                         64, mem_rate, "seamless cross")

    # (c) internvl2-2b: patch embeddings before the prompt
    arch = "internvl2-2b"
    r = serve_family(torch, np, dev, arch)
    n_params, B, S, n_new, cache_len = P8[arch]
    F = r["cfg"].frontend_len
    la = launches[arch] = r["launches"]
    n_l = r["cfg"].n_layers
    check(la["flash_attention"] == n_l and la["decode_attention"]
          == n_l * (n_new - 1) and la["window_ref_decodes"] == 0,
          f"internvl2 launches {la}")
    check(r["positions"][0] == F + S,
          f"internvl2 first decode pos {r['positions'][0]} != {F + S}")
    log(f"[p8] internvl2: {F} patch embeddings + {S} tokens: flash "
        f"{la['flash_attention']} a prefill, decode "
        f"{la['decode_attention'] // (n_new - 1)} a step; decode positions "
        f"{r['positions'][0]}..{r['positions'][-1]}")
    del r
    free_card(torch, "internvl2")

    # (d) gemma3-12b: head dim 256, 40 windowed and 8 global layers
    arch = "gemma3-12b"
    r = serve_family(torch, np, dev, arch)
    n_params, B, S, n_new, cache_len = P8[arch]
    la = launches[arch] = r["launches"]
    model = r["model"]
    n_win = sum(b.kind == "attn" and b.spec.window is not None
                for b in model.blocks) * model.n_groups
    n_glob = sum(b.kind == "attn" and b.spec.window is None
                 for b in model.blocks) * model.n_groups
    check((n_win, n_glob) == GEMMA3_LAYERS,
          f"gemma3 layers {n_win}, {n_glob}")
    check(la["flash_attention"] == n_win + n_glob,
          f"gemma3 flash launches {la['flash_attention']} != "
          f"{n_win + n_glob}")
    check(la["decode_attention"] == n_glob * (n_new - 1)
          and la["window_ref_decodes"] == n_win * (n_new - 1),
          f"gemma3 decode launches {la}")
    window = r["cfg"].local_window
    log(f"[p8] gemma3: flash {la['flash_attention']} a prefill ({n_win} "
        f"windowed at {window}, {n_glob} global; head dim "
        f"{r['cfg'].head_dim}), a step {la['decode_attention'] // (n_new - 1)}"
        f" decode-kernel launches (global) and "
        f"{la['window_ref_decodes'] // (n_new - 1)} attention_ref decodes "
        f"(windowed); peak device memory serving {r['peak']:,} B")
    H, Hkv, hd = r["cfg"].n_heads, r["cfg"].n_kv_heads, r["cfg"].head_dim
    del r, model
    free_card(torch, "gemma3")
    rnd = attn_rnd(torch, dev, 4)
    attn["gemma3_flash"] = flash_row(torch, FA, rnd, B, S, H, Hkv, hd,
                                     mem_rate, "gemma3 global")
    attn["gemma3_window_flash"] = flash_row(
        torch, FA, rnd, B, S, H, Hkv, hd, mem_rate, "gemma3 window",
        window=window)
    attn["gemma3_decode"] = decode_row(torch, DA, rnd, B, cache_len, H, Hkv,
                                       hd, mem_rate, "gemma3")
    for name, row in attn.items():
        log_attn_row(name.rsplit("_", 1)[1], name.rsplit("_", 1)[0], row)
    torch.cuda.empty_cache()
    log(f"[p8] phase 8 wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, attn


# ---------------------------------------------------------------------------
# Phase 9: the distributed layer, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# (a)'s and (c)'s tolerances in bf16, fixed before the first run (PERF.md):
# the loss of a step split over two ranks may part from the one-process
# run's by the bf16 rounding of activations and gradients that other
# GEMM shapes and a reduction in bf16 make; a wrong shard, step or batch
# row parts it by the loss's step-to-step fall or more
DIST_LOSS_TOL = 1e-2
# the pod-mean gradient against the one-process gradient, relative L2:
# bf16 rounding of two half-batch gradients (none, bf16), plus the int8
# blocks' absmax/127/2 (int8)
POD_GRAD_TOL = {"none": 2e-2, "bf16": 2e-2, "int8": 4e-2}
# repro-100m's gradient in f32: its tree holds 128,994,048 params, 768
# more than ArchConfig.param_count()'s analytic 128,993,280
F32_GRAD_BYTES = 515_976_192
DIST_TIMEOUT = 600


def _dist_rank(rank, world, root):
    """One of two ranks sharing the card (gloo): (a) elastic restore,
    (b) int8 restore decoded on the card, (c) compressed pods. Returns
    what the parent prints and checks; raises on any failed check."""
    import os
    import torch
    from repro_torch.ckpt import LocalFSStore, restore, save_checkpoint
    from repro_torch.ckpt import compression
    from repro_torch.ckpt.layout import host_array, np_dtype
    from repro_torch.ckpt.reader import _overlap
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, qsnap
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.specs import (local_slice, make_axes,
                                            mesh_placements, param_specs,
                                            region_of, shardings)
    from repro_torch.train.grad_compress import (make_compressed_train_step,
                                                 payload_bytes,
                                                 pod_mean_compressed)
    from repro_torch.train.optimizer import AdamWConfig, lr_at
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           shard_state, state_dims)
    from repro_torch.tree import leaves_with_path, tree_leaves, tree_map
    import numpy as np

    def need(cond, msg):
        if not cond:
            raise RuntimeError(f"rank {rank}: {msg}")

    need(build.library_path("qsnap").exists(),
         "the qsnap kernels are not built (phase 1 builds them)")
    dev = resolve_device("cuda")
    cfg = get_config("repro-100m")
    model = build_model(cfg)
    opt = AdamWConfig(warmup_steps=2, total_steps=KSTEPS + MORE)
    out = {"rank": rank}
    sync = torch.cuda.synchronize

    # ---- one process: 4 steps, the reference ---------------------------
    t0 = time.perf_counter()
    state0 = init_state(model, 0, dev)
    single = make_train_step(model, opt)
    pipe = TokenPipeline(cfg, BATCH, SEQ)
    ref_losses, ref_states, s = [], [], state0
    for k in range(4):
        s, m = single(s, pipe.next(dev))
        ref_losses.append(float(m["loss"]))
        if k < 2:
            ref_states.append(s)
    del s
    out["ref_losses"] = ref_losses
    out["ref_s"] = time.perf_counter() - t0

    def equal_slices(tree, whole):
        return all(torch.equal(t.to_local(), local_slice(w, t))
                   for t, w in zip(tree_leaves(tree), tree_leaves(whole)))

    # ---- (a) 2 steps on A = (data 1, model 2), save, restore on B -------
    t0 = time.perf_counter()
    mesh_a = make_test_mesh((1, 2), ("data", "model"))
    axes_a = make_axes(mesh_a)
    st = shard_state(model, state0, mesh_a, axes_a)
    step_a = make_train_step(model, opt, mesh=mesh_a, axes=axes_a)
    pipe2 = TokenPipeline(cfg, BATCH, SEQ)
    a_losses, a_exact = [], []
    for k in range(2):
        st, m = step_a(st, pipe2.next(dev))
        a_losses.append(float(m["loss"]))
        a_exact.append(a_losses[-1] == ref_losses[k]
                       and equal_slices(st, ref_states[k]))
    sync()
    out["a_losses"], out["a_exact"] = a_losses, a_exact
    need(all(a_exact), f"mesh A steps differ from one process: {a_losses} "
         f"vs {ref_losses[:2]}, exact {a_exact}")
    out["a_steps_s"] = time.perf_counter() - t0

    store = LocalFSStore(os.path.join(root, "lossless"))
    t0 = time.perf_counter()
    man = save_checkpoint(store, "job", 2,
                          {"state": st, "data": pipe2.state_dict()},
                          codec="raw")
    out["save_s"] = time.perf_counter() - t0
    out["save_bytes"] = sum(c.nbytes for li in man.leaves.values()
                            for c in li.chunks)
    out["save_chunks"] = sum(len(li.chunks) for li in man.leaves.values())
    mesh_b = make_test_mesh((2, 1), ("data", "model"))
    axes_b = make_axes(mesh_b, use_fsdp=True)
    sh_b = shardings(param_specs(state_dims(model), state0, axes_b), mesh_b)
    t0 = time.perf_counter()
    snap, _ = restore(store, "job", shardings={"state": sh_b, "data": None},
                      device=dev)
    sync()
    out["restore_s"] = time.perf_counter() - t0
    st_b = snap["state"]
    out["restore_local_bytes"] = sum(t.to_local().numel()
                                     * t.to_local().element_size()
                                     for t in tree_leaves(st_b))
    out["moved"] = sum(tuple(a.placements) != tuple(b.placements)
                       for a, b in zip(tree_leaves(st), tree_leaves(st_b)))
    out["n_leaves"] = len(tree_leaves(st_b))
    out["reshard_exact"] = equal_slices(st_b, ref_states[1])
    need(out["reshard_exact"], "restored shards differ from the saved state")
    pipe3 = TokenPipeline(cfg, BATCH, SEQ)
    pipe3.load_state_dict(snap["data"])
    del st, snap, ref_states
    t0 = time.perf_counter()
    step_b = make_train_step(model, opt, mesh=mesh_b, axes=axes_b)
    b_losses = []
    for _ in range(2):
        st_b, m = step_b(st_b, pipe3.next(dev))
        b_losses.append(float(m["loss"]))
    sync()
    out["b_steps_s"] = time.perf_counter() - t0
    out["b_losses"] = b_losses
    out["elastic_gap"] = abs(b_losses[-1] - ref_losses[3])
    need(out["elastic_gap"] <= DIST_LOSS_TOL,
         f"elastic loss {b_losses[-1]} vs one process {ref_losses[3]}")

    # ---- (b) the B state as an int8 image, restored on A on the card ----
    store8 = LocalFSStore(os.path.join(root, "int8"))
    q0 = qsnap.LAUNCHES["quantize"]
    t0 = time.perf_counter()
    man8 = save_checkpoint(store8, "job", 4, {"state": st_b}, codec="int8")
    out["int8_save_s"] = time.perf_counter() - t0
    out["int8_quantize_launches"] = qsnap.LAUNCHES["quantize"] - q0
    need(out["int8_quantize_launches"] == 0,
         "DTensor leaves went to the device encoder")
    out["int8_bytes"] = sum(c.nbytes for li in man8.leaves.values()
                            for c in li.chunks)
    specs_a = param_specs(state_dims(model), state0, axes_a)
    sh_a = shardings(specs_a, mesh_a)
    want = 0
    by_name = dict(leaves_with_path({"state": sh_a}))
    for name, li in man8.leaves.items():
        if li.dtype not in ("float32", "bfloat16"):
            continue
        sh = by_name[tuple(name.split("/"))]
        off, shp = region_of(li.shape, mesh_a, sh.placements)
        want += sum(_overlap(off, shp, c.offset, c.shape) is not None
                    for c in li.chunks)
    d0 = qsnap.LAUNCHES["dequantize"]
    t0 = time.perf_counter()
    snap8, _ = restore(store8, "job", shardings={"state": sh_a}, device=dev)
    sync()
    out["int8_restore_s"] = time.perf_counter() - t0
    out["dequantize_launches"] = qsnap.LAUNCHES["dequantize"] - d0
    out["dequantize_overlaps"] = want
    need(out["dequantize_launches"] == want,
         f"{out['dequantize_launches']} dequantize launches, {want} "
         f"(region, int8 chunk) overlaps")
    restored = dict(leaves_with_path(snap8))
    for name, li in man8.leaves.items():          # the host decoder
        t = restored[tuple(name.split("/"))]
        off, shp = region_of(li.shape, t.device_mesh, t.placements)
        region = np.zeros(shp, np_dtype(li.dtype))
        for c in li.chunks:
            ov = _overlap(off, shp, c.offset, c.shape)
            if ov is None:
                continue
            raw = compression.decode(store8.get(c.key), li.dtype, man8.codec)
            region[ov[0]] = np.frombuffer(
                raw, np_dtype(li.dtype)).reshape(c.shape)[ov[1]]
        need(host_array(t.to_local()).tobytes() == region.tobytes(),
             f"device decode of {name} != host decoder")
    del snap8, st_b, restored

    # ---- (c) compressed pods: (pod 2), 4 sequences a pod ----------------
    mesh_p = make_test_mesh((2,), ("pod",))
    group = mesh_p.get_group("pod")
    batch = TokenPipeline(cfg, BATCH, SEQ).next(dev)
    ref_state, m = single(state0, batch)
    ref_loss = float(m["loss"])
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      state0["params"])
    with torch.enable_grad():
        loss, _ = model.loss(params, batch)
        ref_grads = torch.autograd.grad(loss, tree_leaves(params))
        half = {k: v[rank * BATCH // 2:(rank + 1) * BATCH // 2]
                for k, v in batch.items()}
        loss, _ = model.loss(params, half)
        pod_grads = torch.autograd.grad(loss, tree_leaves(params))
    del params
    need(sum(g.numel() for g in pod_grads) * 4 == F32_GRAD_BYTES,
         "repro-100m's gradient is not 515,976,192 B in f32")
    lr0 = float(lr_at(opt, torch.zeros((), dtype=torch.int32)))
    out["pods"] = {}
    for codec in ("none", "bf16", "int8"):
        step = make_compressed_train_step(model, opt, mesh_p, codec=codec)
        sync()
        t0 = time.perf_counter()
        new, m = step(state0, batch)
        sync()
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        red = [pod_mean_compressed(g, codec, group) for g in pod_grads]
        sync()
        mean_s = time.perf_counter() - t0
        num = sum(float((r.float() - g.float()).square().sum())
                  for r, g in zip(red, ref_grads))
        den = sum(float(g.float().square().sum()) for g in ref_grads)
        grad_rel = (num / den) ** 0.5
        # |p - p_ref| <= 2 lr + one bf16 ulp (1% over, for f32 rounding):
        # Adam's first update moves a weight by at most lr, and each side
        # rounds to bf16 once, by at most half an ulp, 2^-8 of its size
        excess = max(float((a.float() - b.float()).abs().sub(1.01 * (
            2 * lr0 + (b.float().abs() + 2 * lr0) * 2.0 ** -7)).max())
            for a, b in zip(tree_leaves(new["params"]),
                            tree_leaves(ref_state["params"])))
        out["pods"][codec] = {
            "loss": float(m["loss"]), "loss_gap": abs(float(m["loss"])
                                                      - ref_loss),
            "grad_rel_l2": grad_rel, "param_excess": excess,
            "payload_bytes": sum(payload_bytes(g, codec) for g in pod_grads),
            "step_s": step_s, "pod_mean_s": mean_s}
        need(out["pods"][codec]["loss_gap"] <= DIST_LOSS_TOL,
             f"{codec}: pod loss {float(m['loss'])} vs {ref_loss}")
        need(grad_rel <= POD_GRAD_TOL[codec],
             f"{codec}: pod-mean gradient {grad_rel:.3e} from one process")
        need(excess <= 0.0, f"{codec}: params past 2 lr + 1 ulp by {excess}")
        del new, red
    out["ref_pod_loss"] = ref_loss
    out["launches"] = {**qsnap.LAUNCHES, **FA.LAUNCHES, **DA.LAUNCHES}
    return out


def dist_phase(torch, np):
    """Phase 9: two ranks sharing the card (gloo, ``launch.mesh.spawn``)
    at repro-100m's full width; returns the ranks' dequantize launches
    (summed) and prints what they measured."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dist-") as root:
        try:
            ranks = spawn(_dist_rank, 2, root, timeout=DIST_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 9: {e}")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        check(r["ref_losses"] == r0["ref_losses"]
              and r["b_losses"] == r0["b_losses"],
              "the ranks' losses differ")
    log(f"[dist] two gloo ranks on one card, repro-100m bf16 "
        f"{BATCH} x {SEQ}; collectives cross host memory (gloo), not "
        f"NVLink or NCCL: their times say nothing of either")
    log(f"[dist] (a) one process, 4 steps: losses {r0['ref_losses']} "
        f"({r0['ref_s']:.3f} s, first step's warmup included)")
    log(f"[dist] (a) mesh A (data 1, model 2): 2 steps, losses "
        f"{r0['a_losses']}, bit-exact with one process (losses and every "
        f"local shard): {r0['a_exact']} ({r0['a_steps_s']:.3f} s)")
    log(f"[dist] (a) lossless save from both ranks: {r0['save_bytes']:,} B "
        f"in {r0['save_chunks']} chunks, {r0['save_s']:.3f} s; restore on "
        f"B (data 2, model 1, FSDP): {r0['restore_local_bytes']:,} B a "
        f"rank in {max(r['restore_s'] for r in ranks):.3f} s; "
        f"{r0['moved']} of {r0['n_leaves']} leaves change placement; every "
        f"local shard equals the saved state's: {r0['reshard_exact']}")
    log(f"[dist] (a) mesh B: 2 steps, losses {r0['b_losses']} "
        f"({r0['b_steps_s']:.3f} s); step 4 against one process "
        f"{r0['ref_losses'][3]}: |gap| {r0['elastic_gap']:.3e} (tolerance "
        f"{DIST_LOSS_TOL})")
    log(f"[dist] (b) int8 save of the B state: {r0['int8_bytes']:,} B in "
        f"{r0['int8_save_s']:.3f} s, quantize launches "
        f"{[r['int8_quantize_launches'] for r in ranks]} (host codec); "
        f"restore on A decoded on the card in "
        f"{max(r['int8_restore_s'] for r in ranks):.3f} s, dequantize "
        f"launches {[r['dequantize_launches'] for r in ranks]} = (region, "
        f"int8 chunk) overlaps {[r['dequantize_overlaps'] for r in ranks]}; "
        f"every local shard equals the host decoder's bytes")
    for codec, p in r0["pods"].items():
        log(f"[dist] (c) pods, codec {codec}: loss {p['loss']} (one process "
            f"{r0['ref_pod_loss']}, |gap| {p['loss_gap']:.3e}); pod-mean "
            f"gradient rel L2 {p['grad_rel_l2']:.3e} (tolerance "
            f"{POD_GRAD_TOL[codec]}); params within 2 lr + 1 bf16 ulp "
            f"(slack {-p['param_excess']:.3e}); payload a pod a step "
            f"{p['payload_bytes']:,} B against f32 {F32_GRAD_BYTES:,} B "
            f"({F32_GRAD_BYTES / p['payload_bytes']:.3f}x); step "
            f"{p['step_s']:.3f} s, pod mean alone {p['pod_mean_s']:.3f} s")
    log(f"[dist] phase 9 wall time {wall:.1f} s (two ranks' start-up "
        f"included)")
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


def run_app(app, restore_state=None):
    app.start(None, restore_state)
    while not app.is_done():
        time.sleep(0.005)
        check(app._thread.is_alive() or app.is_done(),
              "app thread died")
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
    cached = all(build.library_path(k).exists() for k in KERNELS)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    build_s = time.perf_counter() - t0
    log("[build] " + ", ".join(f"csrc/{k}.cu -> {build.library_path(k).name}"
                               for k in KERNELS)
        + f" in {build_s:.2f} s, in parallel"
        + (" (already built)" if cached else ""))

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

    dequantize_edges(torch, qsnap, dev, gen, err)

    cfg = get_config("repro-100m")
    model = build_model(cfg)
    leaves = [t for t in tree_leaves(init_state(model, 0, dev))
              if t.is_floating_point()]
    n_elems = sum(t.numel() for t in leaves)
    encoded = [qsnap.qsnap_quantize_cuda(t.reshape(-1)) for t in leaves]
    big = max(leaves, key=lambda t: t.numel() * t.element_size()).reshape(-1)
    big_c, big_s = qsnap.qsnap_quantize_cuda(big)
    big16 = max((t for t in leaves if t.dtype == torch.bfloat16),
                key=torch.Tensor.numel).reshape(-1)
    big16_c, big16_s = qsnap.qsnap_quantize_cuda(big16)
    one = {   # one launch on the largest leaf: the kernel without gaps
        "quantize": lambda: qsnap.qsnap_quantize_cuda(big),
        "dequantize": lambda: qsnap.qsnap_dequantize_cuda(big_c, big_s,
                                                          big.dtype)}
    big_ms = {k: time_ms(torch, fn, 50) for k, fn in one.items()}
    big_dev_ms = {k: graph_ms(torch, fn, 100) for k, fn in one.items()}
    one16 = lambda: qsnap.qsnap_dequantize_cuda(big16_c, big16_s,
                                                torch.bfloat16)
    big16_ms, big16_dev_ms = time_ms(torch, one16, 50), \
        graph_ms(torch, one16, 100)
    leaf_bytes_of = lambda t: t.numel() * (t.element_size() + 1) \
        + 4 * (t.numel() // 256)
    big_bytes, big16_bytes = leaf_bytes_of(big), leaf_bytes_of(big16)
    big_bound = big_bytes / mem_rate * 1e3
    big16_bound = big16_bytes / mem_rate * 1e3
    # the card's reachable copy rate: one copy_ moving the same bytes
    # (read half, write half); a yardstick of bandwidth, not library_ms
    copy_dev_ms = {}
    for k, nbytes in (("f32", big_bytes), ("bf16", big16_bytes)):
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_dev_ms[k] = graph_ms(torch, lambda: dst.copy_(src), 100)
        del src, dst
    all_leaves = {
        "quantize": (lambda: [qsnap.qsnap_quantize_cuda(t.reshape(-1))
                              for t in leaves],
                     lambda: [qsnap.qsnap_quantize_plain(t.reshape(-1))
                              for t in leaves]),
        "dequantize": (lambda: [qsnap.qsnap_dequantize_cuda(c, s, t.dtype)
                                for t, (c, s) in zip(leaves, encoded)],
                       lambda: [qsnap.qsnap_dequantize_plain(c, s, t.dtype)
                                for t, (c, s) in zip(leaves, encoded)])}
    times = {k: (time_ms(torch, fn, 20), time_ms(torch, plain, 5))
             for k, (fn, plain) in all_leaves.items()}
    dev_times = {k: graph_ms(torch, fn, 20)
                 for k, (fn, _) in all_leaves.items()}
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
            f"{ms:.4f} ms (device {dev_times[k]:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bounds[k][0]:.4f} ms "
            f"({bounds[k][1]}); no single PyTorch call computes it")
        log(f"[kernels] {k} one launch on the largest leaf "
            f"({big.numel():,} {str(big.dtype)[6:]}): {big_ms[k]:.4f} ms "
            f"(device {big_dev_ms[k]:.4f} ms), bound {big_bound:.4f} ms")
    log(f"[kernels] dequantize one launch on the largest bf16 leaf "
        f"({big16.numel():,} bfloat16 out): {big16_ms:.4f} ms (device "
        f"{big16_dev_ms:.4f} ms), bound {big16_bound:.4f} ms")
    for k, nbytes in (("f32", big_bytes), ("bf16", big16_bytes)):
        log(f"[kernels] copy yardstick beside dequantize ({k} out): one "
            f"torch.Tensor.copy_ moving the same {nbytes:,} bytes, device "
            f"{copy_dev_ms[k]:.4f} ms ({nbytes / copy_dev_ms[k] / 1e9:.3f} "
            f"TB/s, the card's reachable copy rate; a yardstick of "
            f"bandwidth, not library_ms)")
    del leaves, encoded, big, big_c, big_s, big16, big16_c, big16_s
    attn = attention_kernels(torch, dev, cfg, mem_rate)

    # ---- 3. main path -----------------------------------------------------
    opt = AdamWConfig(warmup_steps=2, total_steps=KSTEPS + MORE)

    def trainer(n_steps, c=cfg, batch=BATCH, seq=SEQ, device=dev):
        return TrainerApp(c, global_batch=batch, seq_len=seq,
                          n_steps=n_steps, opt=opt, device=device)

    log(f"[main] {cfg.name} {cfg.dtype}: {cfg.param_count():,} params, "
        f"batch {BATCH} x seq {SEQ}, {KSTEPS} steps, int8 swap-out, restore, "
        f"{MORE} more steps")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
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
    launches = read_launches()
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
    check(launches["flash_attention"] == launches["decode_attention"] == 0,
          "training ran an attention kernel: it keeps attention_ref")
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
    straight_losses = list(straight.losses)
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
    state = [init_state(model, 0, dev)]
    batch = TokenPipeline(cfg, BATCH, SEQ).next(dev)
    train_step = make_train_step(model, opt)

    def one_step():
        state[0], m = train_step(state[0], batch)
        float(m["loss"])
    log_profile("train step", profile_steps(torch, one_step))
    del state

    # ---- 4. serving path --------------------------------------------------
    serve_launches, stream = serve_phase(torch, np, dev, cfg)

    # ---- 5. the control plane ----------------------------------------------
    svc_train, svc_serve = service_phase(torch, np, dev, cfg, trainer,
                                         straight_losses, stream)

    # ---- 6. the scheduler, failover and the fleet --------------------------
    sched_train = preempt_phase(torch, np, dev, cfg, trainer, stream)
    failover_phase(torch, np, dev, cfg, trainer, straight_losses)
    sched_fleet = fleet_phase(torch, np, dev, cfg, stream)
    sched = {k: sched_train[k] + sched_fleet[k] for k in sched_train}

    # ---- 7. jamba: the MoE and Mamba blocks at full width -------------------
    jamba_launches, jamba_attn = jamba_phase(torch, np, dev, mem_rate)

    # ---- 8. the xLSTM, enc-dec and vlm families, gemma3 at full width ----
    p8_launches, p8_attn = families_phase(torch, np, dev, mem_rate)

    # ---- 9. the distributed layer: two ranks sharing the card -------------
    dist_launches = dist_phase(torch, np)

    # ---- 10. report -------------------------------------------------------
    src = "src/repro_torch/kernels/csrc/qsnap.cu"
    rows = []
    for k, line in (("quantize", 29), ("dequantize", 41)):
        ms, plain_ms = times[k]
        rows.append({
            "name": f"qsnap_{k}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/qsnap.py:{line}",
            "launches": launches[k], "service_launches": svc_train[k],
            "sched_launches": sched[k], "jamba_launches": jamba_launches[k],
            "p8_launches": {a: c[k] for a, c in p8_launches.items()},
            "dist_launches": dist_launches[k],
            "max_abs_err": err[k],
            "bitexact": err[k] == 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": None, "elements": n_elems,
            "device_ms": dev_times[k], "largest_leaf_ms": big_ms[k],
            "largest_leaf_device_ms": big_dev_ms[k],
            "largest_leaf_bound_ms": big_bound})
    rows[1].update(largest_bf16_leaf_ms=big16_ms,
                   largest_bf16_leaf_device_ms=big16_dev_ms,
                   largest_bf16_leaf_bound_ms=big16_bound,
                   largest_leaf_copy_device_ms=copy_dev_ms["f32"],
                   largest_bf16_leaf_copy_device_ms=copy_dev_ms["bf16"])
    for k, line in (("flash_attention", 29), ("decode_attention", 26)):
        served, long_ = attn[(k.split("_")[0], "served")], \
            attn[(k.split("_")[0], "long")]
        rows.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k}.cu",
            "replaces": f"src/repro/kernels/{k}.py:{line}",
            "launches": serve_launches[k],
            "service_launches": svc_serve[k], "sched_launches": sched[k],
            "jamba_launches": jamba_launches[k],
            "p8_launches": {a: c[k] for a, c in p8_launches.items()},
            "dist_launches": dist_launches[k],
            **served,
            **{f"long_{f}": val for f, val in long_.items()},
            **{f"jamba_{f}": val
               for f, val in jamba_attn[k.split("_")[0]].items()},
            **{f"{where}_{f}": val
               for where in ("gemma3", "gemma3_window", "seamless")
               if f"{where}_{k.split('_')[0]}" in p8_attn
               for f, val in p8_attn[f"{where}_{k.split('_')[0]}"].items()}})
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
