"""A training job hosted by ``CACSService``, swapped out and back.

Set-up draws the weights on the device from the seed and builds one
``TrainerApp``, which the service starts on that state through the
restore path of the program's own ``start`` (a restore at step 0); it is
submitted to a ``CACSService`` (a Snooze backend, an in-memory store,
swap-outs in the traffic's codec). The job's first steps run through its
own loop and feed; the harness reads the loss of each and the job's state
after steps 1 and ``checked_steps`` for the check.

The window opens at a step boundary, and the job is suspended at once
(``svc.apps.suspend``: pinned, encoded on the card, hashed and written)
and resumed (``svc.apps.resume``: fetched, decoded onto the card); it
trains for the rest of the window. Nothing polls the job inside the
window: the steps it kept are read after the close from the program's own
record, ``TrainerApp.step_times``.

The swap is checked on a sample drawn from the seed: of every float leaf,
``sample_blocks`` of the codec's 256-value blocks and the last one,
gathered from the state the swap-out pins and from the state the resume
hands back (the integer leaves whole), and compared once the window has
closed. Then the program is let go, and the reference runs the first
steps again from the same weights and batches.
"""
from __future__ import annotations

import gc
import statistics
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cacs_bench import compare, devtrace, flops
from cacs_bench import weights as W
from cacs_bench.harness import Check, Ctx, Run
from cacs_bench.port import arch_config, build_kernels, param_shapes
from cacs_bench.reference import dense, int8, lowp
from cacs_bench.reference.tokens import batch_at

POLL_S = 0.005                     # s; outside the window only
BLOCK = int8.BLOCK


def _flat_state(snap: dict) -> Dict[str, torch.Tensor]:
    return W.flatten(snap["state"])


def _wait(pred, deadline: float) -> bool:
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(POLL_S)
    return True


def block_pick(state: Dict[str, torch.Tensor], seed: int,
               per_leaf: int) -> Dict[str, torch.Tensor]:
    """For each float leaf, ``per_leaf`` of its whole 256-value blocks
    drawn from the seed (all of them where it has fewer), as indices on
    the leaf's device."""
    rng = np.random.Generator(np.random.PCG64([seed, 2]))
    pick = {}
    for n in sorted(state):
        t = state[n]
        if t.is_floating_point():
            full = t.numel() // BLOCK
            pick[n] = torch.as_tensor(np.sort(rng.choice(
                full, size=min(per_leaf, full), replace=False)),
                device=t.device)
    return pick


def gather(state: Dict[str, torch.Tensor],
           pick: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The picked blocks of each float leaf ([k, 256]) and its last,
    partial block under ``<leaf>#tail``; integer leaves whole."""
    out = {}
    for n, t in state.items():
        if n not in pick:
            out[n] = t.clone()
            continue
        flat = t.detach().reshape(-1)
        full = flat.numel() // BLOCK
        out[n] = flat[:full * BLOCK].view(full, BLOCK)[pick[n]]
        if flat.numel() > full * BLOCK:
            out[n + "#tail"] = flat[full * BLOCK:].clone()
    return out


def swap_gap(restored: Dict[str, torch.Tensor],
             pinned: Dict[str, torch.Tensor]) -> float:
    """Worst leaf's gap, in int8 codes, between the restored state and the
    reference's round trip of the pinned one (whole leaves, or the blocks
    ``gather`` took of them); an integer leaf must come back equal."""
    gaps = [0.0]
    for n, want in pinned.items():
        got = restored[n]
        if want.is_floating_point():
            gaps.append(int8.gap_in_codes(got, want))
        elif not torch.equal(got.cpu(), want.cpu()):
            gaps.append(float("inf"))
    return max(gaps)


def kept_steps(step_times: List[float], first: int, seen: int,
               t_close: float, t_end: float) -> float:
    """The steps kept in the window: the ``seen - first`` whole steps
    the job made after its resume, and the share done at ``t_close`` of
    the step then under way, which ended at ``t_end`` and took
    ``step_times[seen]`` (``t_end`` is ``None`` where it never ended)."""
    part = 0.0
    if t_end is not None and seen < len(step_times):
        d = step_times[seen]
        part = min(1.0, max(0.0, 1.0 - (t_end - t_close) / d))
    return (seen - first) + part


def run(ctx: Ctx) -> Run:
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import ASR, CACSService, CheckpointPolicy, CoordState
    from repro_torch.obs.trace import tracer
    from repro_torch.sim.simtime import active_clock
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainerApp
    from repro_torch.tree import tree_leaves

    tr, port, dev = ctx.traffic, ctx.config["port"], ctx.device
    B, S = tr["global_batch"], tr["seq_len"]
    opt = tr["optimizer"]
    cfg = arch_config(port)
    build_kernels(dev, ("qsnap",))
    if dev.type == "cuda":                  # load the kernels' module
        from repro_torch.kernels.qsnap import qsnap_dequantize, qsnap_quantize
        qsnap_dequantize(*qsnap_quantize(torch.ones(512, device=dev)))
        torch.cuda.synchronize()
    ctx.mark("port and kernels")
    shapes = param_shapes(cfg)
    p0 = W.draw(shapes, ctx.config["init"], ctx.seed, dev)
    ctx.mark("weights")
    params = W.nest(p0)
    first = [{"params": params, "opt_state": adamw_init(params),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}]
    del params

    class Seeded(TrainerApp):
        """The program's trainer, started on the harness's state as a
        restore at step 0."""

        def start(self, app_ctx, restore_state):
            if restore_state is None and first:
                restore_state = {"state": first.pop(), "data": dict(
                    self.pipeline.state_dict(), step=0)}
            super().start(app_ctx, restore_state)

    app = Seeded(cfg, global_batch=B, seq_len=S, n_steps=tr["n_steps"],
                 opt=AdamWConfig(**opt), seed=ctx.seed, remat=tr["remat"],
                 device=dev)
    svc = CACSService({"snooze": SnoozeBackend(tr["backend_hosts"])},
                      {"default": InMemoryStore()})
    cid = svc.submit(ASR(
        name=ctx.cell["name"], n_vms=1, backend="snooze",
        app_factory=lambda: app,
        policy=CheckpointPolicy(period_s=0, codec="raw",
                                swap_codec=tr["swap_codec"],
                                keep_last=tr["keep_last"])))
    svc.wait_for_state(cid, CoordState.RUNNING, 600)
    ctx.mark("submitted")
    far = ctx.t_start + 330                 # a run ends within 360 s
    errors: List[str] = []

    def loop_alive() -> bool:
        return bool(app._thread and app._thread.is_alive())

    def reach(k: int) -> None:
        """Wait for step ``k``; raise if the job's loop ends first."""
        _wait(lambda: app.current_step >= k or not loop_alive(), far)
        if app.current_step < k:
            raise RuntimeError(f"the training loop stopped before step {k} "
                               f"(at {app.current_step})")

    # -- the first steps, each state read before the next step replaces it
    def state_at(k: int) -> Dict[str, torch.Tensor]:
        reach(k)
        snap = app.checkpoint_state()
        if snap["data"]["step"] != k:
            errors.append(f"read the state at step {snap['data']['step']}, "
                          f"not {k}")
        return _flat_state(snap)

    st = state_at(1)
    prog_g1 = {n[len("opt_state.m."):]: float((t / (1 - opt["b1"])).norm())
               for n, t in st.items() if n.startswith("opt_state.m.")}
    k_chk = tr["checked_steps"]
    st = state_at(k_chk)
    prog_delta = {n[len("params."):]: float(
        (t.float() - p0[n[len("params."):]].float()).norm())
        for n, t in st.items() if n.startswith("params.")}
    prog_losses = list(app.losses[:k_chk])
    float_leaves = [(t.numel(), t.element_size()) for t in tree_leaves(
        app.checkpoint_state()["state"]) if t.is_floating_point()]
    pick = block_pick(st, ctx.seed, tr["sample_blocks"])
    del st, p0

    # -- the window: it opens at a step boundary with the swap ------------
    window = devtrace.DeviceWindow(ctx.trace)
    window.start()
    reach(app.current_step + 1)
    window.open()
    t_open = time.monotonic()
    ctx.mark("first steps")
    tracer().reset()
    deadline = t_open + ctx.seconds
    closing: dict = {}

    def close() -> None:
        window.close()
        closing.update(t=time.monotonic(), seen=len(app.step_times))

    timer = threading.Timer(ctx.seconds, close)
    timer.start()
    held = app.checkpoint_state()
    t0n, t0 = time.time_ns(), time.monotonic()
    t1n = t2n = t0n
    t1 = t2 = float("inf")
    first_kept = 0
    sampled: Optional[tuple] = None        # (restored, pinned) blocks
    failed = 0
    try:
        svc.apps.suspend(cid)
        t1n, t1 = time.time_ns(), time.monotonic()
        first_kept = len(app.step_times)   # the loop has stopped
        svc.apps.resume(cid)
        t2n, t2 = time.time_ns(), time.monotonic()
        snap = app.checkpoint_state()
        pinned, restored = held["data"]["step"], snap["data"]["step"]
        if restored != pinned:
            errors.append(f"the swap handed back step {restored}; the "
                          f"state held as it began is step {pinned}")
        sampled = (gather(_flat_state(snap), pick),
                   gather(_flat_state(held), pick))
        del snap
    except Exception as e:                         # noqa: BLE001
        errors.append(f"swap: {type(e).__name__}: {e}")
        failed += 1
    del held
    timer.join()
    t_close, seen = closing["t"], closing["seen"]
    t_end = None
    if not failed and t2 > t_close:
        errors.append("the window closed before the swap was done")
        failed += 1
    elif not failed:
        # until the step under way at the close has ended
        if _wait(lambda: len(app.step_times) > seen or not loop_alive(),
                 far) and len(app.step_times) > seen:
            t_end = time.monotonic()
    if not failed and not loop_alive():
        errors.append(f"the training loop ended in the window, at step "
                      f"{app.current_step}")
        failed += 1
    window.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    step_times = list(app.step_times)
    kept = (kept_steps(step_times, first_kept, seen, t_close, t_end)
            if t2 <= t_close else 0.0)
    resume_s = (t2 - t1 + step_times[first_kept]
                if t2 <= t_close and first_kept < len(step_times) else None)

    scale = active_clock().scale
    epoch = time.time() - time.monotonic()
    spans = {name: [s.duration * scale for s in tracer().spans(name=name)
                    if s.t0 * scale < deadline]
             for name in ("ckpt/save", "ckpt/restore")}
    ckpt_spans = [(s.name, int((s.t0 * scale + epoch) * 1e9),
                   int((s.t1 * scale + epoch) * 1e9))
                  for s in tracer().spans(cat="ckpt")]
    gap = swap_gap(*sampled) if sampled is not None else None
    del sampled
    app.stop()
    svc.shutdown()
    del app, svc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference: the same weights, batches and steps --------------
    lowp.set_exact_matmul()
    ref_p0 = W.draw(shapes, ctx.config["init"], ctx.seed, dev)
    batches = [batch_at(ctx.seed, k, B, S, port["vocab_size"])
               for k in range(k_chk)]
    ref = dense.train(ref_p0, batches, port, opt)
    del ref_p0
    moved = compare.moved_leaves(ref["grad1_raw"])
    numbers = {
        "loss_gap": max(compare.rel_gap(g, w) for g, w in
                        zip(prog_losses, ref["losses"])),
        "grad1_gap": compare.worst_leaf_gap(prog_g1, ref["grad1"]),
        "update_gap": compare.worst_leaf_gap(prog_delta, ref["delta"], moved),
        "swap_codes": float("inf") if gap is None else gap,
    }
    ctx.log(f"[train_swap] readings {numbers}")
    checks = [Check(k, v, ctx.limits[k]) for k, v in numbers.items()
              if k in ctx.limits]

    def label(s: int, e: int) -> str:
        mid = (s + e) // 2
        inner = [(t1 - t0, n) for n, t0, t1 in ckpt_spans if t0 <= mid < t1]
        if inner:
            return min(inner)[1]
        for kind, t0, t1 in (("suspend", t0n, t1n), ("resume", t1n, t2n)):
            if t0 <= mid < t1:
                return kind
        return "train step"

    kept_times = step_times[first_kept:seen]
    data = {
        "setup_s": t_open - ctx.t_start,
        "window_s": t_close - t_open,
        "progress_steps": kept,
        "tokens_per_step": B * S,
        "suspend_s": t1 - t0 if t1 <= t_close else None,
        "resume_s": resume_s,
        "ckpt_save_s": spans["ckpt/save"],
        "ckpt_restore_s": spans["ckpt/restore"],
        "step_times": kept_times,
        "train_flops_per_token": flops.train_flops_per_token(shapes, port, S),
        "float_leaves": float_leaves,
        "device_kind": torch.cuda.get_device_name(0)
        if dev.type == "cuda" else "cpu",
    }
    ctx.log(f"[train_swap] window {data['window_s']:.3f} s, steps kept "
            f"{kept:.3f}, suspend {data['suspend_s']} s, resume {resume_s} "
            f"s, step ms median "
            f"{1e3 * statistics.median(kept_times) if kept_times else 0:.1f};"
            f" losses {prog_losses} vs reference {ref['losses']}")
    return Run(data=data, checks=checks,
               attempted=len(kept_times) + 2, failed=failed,
               memory_peak_bytes=memory_peak, window=window, label=label,
               error="; ".join(errors) or None)
