"""A batch of greedy generations served by a ``ServeApp`` under
``CACSService``, timed step by step.

Set-up draws the weights on the device from the seed, hands them to one
``ServeApp`` and submits it; the job prefills its prompt rows (drawn from
the seed) and decodes. The window opens at a decode-step boundary once
``warm_steps`` steps have run, and the harness takes a timestamp each
time the job's count of generated tokens grows (it waits on the job's
condition, which the decode loop notifies every step; one wake that sees
k steps gives each 1/k of the gap). After the window the job is stopped,
and ``check_rows`` rows drawn from the seed are run through the
reference over their prompt and every token served; the check compares
the mean, over every position, of the gap by which the served token's
logit lies below the reference's best (the widest gap is logged: a
routing flip at a near tie of the second and third expert sets it alike
in bfloat16 and float8, so it does not tell them apart).
"""
from __future__ import annotations

import gc
import time
from typing import List

import numpy as np
import torch

from cacs_bench import devtrace, flops
from cacs_bench import weights as W
from cacs_bench.harness import Check, Ctx, Run
from cacs_bench.port import arch_config, build_kernels, param_shapes
from cacs_bench.reference import hybrid, lowp
from cacs_bench.reference.tokens import prompt as prompt_rows


def gap_stats(logits: torch.Tensor, chosen: torch.Tensor) -> dict:
    """How far below the reference's best logit the chosen tokens lie,
    over every position: the widest gap, the mean gap, the 90th
    percentile and the share of positions not at the reference's
    argmax."""
    best = logits.max(dim=-1).values
    each = (best - logits.gather(-1, chosen.long()[..., None])[..., 0]
            ).float().reshape(-1)
    return {"max": float(each.max()), "mean": float(each.mean()),
            "p90": float(each.quantile(0.9)),
            "miss": float((each > 0).float().mean()),
            "positions": int(each.numel())}


def reference_logits(p, port, prompts, served, mode="f32"):
    """Logits at the positions that chose each served token: the prompt,
    then the served tokens but the last, as one sequence."""
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    P = prompts.shape[1]
    logits = hybrid.forward_logits(p, hybrid.period_blocks(port), seq, port,
                                   prompt_len=P, mode=mode)
    return logits[:, P - 1:]


def run(ctx: Ctx) -> Run:
    from repro_torch.ckpt import InMemoryStore
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import ASR, CACSService, CheckpointPolicy, CoordState
    from repro_torch.serve.engine import ServeApp

    tr, port, dev = ctx.traffic, ctx.config["port"], ctx.device
    B, P = tr["batch"], tr["prompt_len"]
    cfg = arch_config(port)
    build_kernels(dev, ("flash_attention", "decode_attention"))
    ctx.mark("port and kernels")
    shapes = param_shapes(cfg)
    params = W.nest(W.draw(shapes, ctx.config["init"], ctx.seed, dev))
    ctx.mark("weights")
    app = ServeApp(cfg, batch=B, prompt_len=P, n_tokens=tr["n_tokens"],
                   cache_len=tr["cache_len"], seed=ctx.seed, device=dev)
    app.params = params
    del params
    svc = CACSService({"snooze": SnoozeBackend(tr["backend_hosts"])},
                      {"default": InMemoryStore()})
    cid = svc.submit(ASR(name=ctx.cell["name"], n_vms=1, backend="snooze",
                         app_factory=lambda: app,
                         policy=CheckpointPolicy(period_s=0)))
    svc.wait_for_state(cid, CoordState.RUNNING, 600)
    ctx.mark("submitted")
    cond = app._cond

    def ended() -> bool:
        """The decode thread is gone: a failure outside its decode steps
        (in the prefill) ends it without a word."""
        return not app._thread.is_alive()

    def wait_more(n: int, until: float) -> int:
        """Block until more than ``n`` tokens are out, the job has made
        all it will, or ``until``; returns the count."""
        with cond:
            while (app.generated <= n and app.generated < tr["n_tokens"]
                   and app.healthy() and not ended()):
                left = until - time.monotonic()
                if left <= 0:
                    break
                cond.wait(timeout=min(left, 0.5))
            return app.generated

    far = time.monotonic() + 3600
    while (app.generated < 1 + tr["warm_steps"] and app.healthy()
           and not ended()):
        wait_more(app.generated, far)
    window = devtrace.DeviceWindow(ctx.trace)
    window.start()
    g_open = wait_more(app.generated, far)
    window.open()
    t_open = t_prev = time.monotonic()
    ctx.mark("prefill and warm steps")
    deadline = t_open + ctx.seconds
    gaps: List[float] = []
    g = g_open
    while app.healthy() and g < tr["n_tokens"]:
        g_new = wait_more(g, deadline)
        now = time.monotonic()
        if now >= deadline or g_new == g:
            break
        k = g_new - g
        gaps += [(now - t_prev) / k] * k
        g, t_prev = g_new, now
    window.close()
    t_close = time.monotonic()
    window.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    gone = ended()                      # then ``generated`` is final
    made = app.generated
    healthy = app.healthy() and not (gone and made < tr["n_tokens"])
    svc.shutdown()
    served_all = (np.concatenate(app.tokens_out, axis=1) if app.tokens_out
                  else np.zeros((B, 0), np.int32))
    n_served = served_all.shape[1]
    del app, svc, cond
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference over the prompt and every token served -----------
    rng = np.random.Generator(np.random.PCG64([ctx.seed, 1]))
    rows = np.sort(rng.choice(B, size=tr["check_rows"], replace=False))
    lowp.set_exact_matmul()
    p = W.draw(shapes, ctx.config["init"], ctx.seed, dev)
    prompts = torch.as_tensor(prompt_rows(ctx.seed, B, P,
                                          port["vocab_size"])[rows],
                              device=dev)
    served = torch.as_tensor(served_all[rows], device=dev)
    control = {}
    stats = {}
    with torch.no_grad():
        if n_served:                    # nothing served: nothing to check
            logits = reference_logits(p, port, prompts, served)
            stats = gap_stats(logits, served)
            ctx.log(f"[serve_decode] served tokens against the reference: "
                    f"{stats}")
            if ctx.extra.get("control"):
                low = reference_logits(p, port, prompts, served, mode="fp8")
                control["fp8"] = gap_stats(logits, low.argmax(-1))
                control["program"] = stats
                del low
            del logits
    del p
    checks = [Check(f"served_gap_{k}", v, ctx.limits[f"served_gap_{k}"])
              for k, v in stats.items() if f"served_gap_{k}" in ctx.limits]

    pos_open = P + g_open - 1
    data = {
        "setup_s": t_open - ctx.t_start,
        "window_s": t_close - t_open,
        "step_gaps": gaps,
        "batch": B,
        "decode_flops": [flops.decode_flops(shapes, port, B, pos_open + i)
                         for i in range(len(gaps))],
        "decode_pos0": pos_open,
        "attn": (B, port["n_heads"], port["n_kv_heads"],
                 port["d_model"] // port["n_heads"]),
        "device_kind": torch.cuda.get_device_name(0)
        if dev.type == "cuda" else "cpu",
        "served_tokens": n_served,
        "control": control,
    }
    ctx.log(f"[serve_decode] window {data['window_s']:.3f} s, "
            f"{len(gaps)} steps of {B}, median gap "
            f"{1e3 * float(np.median(gaps)) if gaps else 0:.2f} ms; checked "
            f"rows {rows.tolist()} over {n_served} served tokens")
    return Run(data=data, checks=checks, attempted=len(gaps) * B,
               failed=0 if healthy else B, memory_peak_bytes=memory_peak,
               window=window, label=lambda s, e: "decode step",
               error=None if healthy else
               f"the decode loop failed or ended at token {made} of "
               f"{tr['n_tokens']}")
