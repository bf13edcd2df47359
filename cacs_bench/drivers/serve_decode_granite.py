"""A batch of greedy generations of granite-4.0-h served by a ``ServeApp``
under ``CACSService``, timed step by step: ``serve_decode``'s cell with
granite's reference and counts.

The run is ``serve_decode.run``, loaded as a module of this driver's own
with three of its globals replaced: its ``reference_logits`` runs
``reference.granite`` over the checked rows; its window reads the
registry's ``moe.routed_pairs`` and ``moe.expert_rows`` as it opens and
after it closes; its decode FLOPs are ``flops.decode_flops``'s plus the
tied head's 2 V d a token, which that count leaves out with the input
embedding.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List

import torch

from cacs_bench import devtrace, flops
from cacs_bench.harness import BENCH, Ctx, Run, load_module
from cacs_bench.reference import granite

COUNTS = ("moe.routed_pairs", "moe.expert_rows")
serve_decode = load_module(BENCH / "drivers" / "serve_decode.py")


def reference_logits(p, port, prompts, served, mode="f32"):
    """Logits at the positions that chose each served token: the prompt,
    then the served tokens but the last, as one sequence."""
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    logits = granite.forward_logits(p, seq, port, mode=mode)
    return logits[:, prompts.shape[1] - 1:]


def counts() -> List[float]:
    from repro_torch.obs.telemetry import registry
    return [registry().value(n) for n in COUNTS]


class CountedWindow(devtrace.DeviceWindow):
    """The device window, with ``COUNTS`` read as it opens and after it
    closes."""

    def open(self) -> None:
        self.counts = [counts()]
        super().open()

    def close(self) -> None:
        super().close()
        self.counts.append(counts())


def decode_flops(shapes, port, B: int, pos: int) -> float:
    return flops.decode_flops(shapes, port, B, pos) \
        + 2.0 * B * port["vocab_size"] * port["d_model"]


serve_decode.reference_logits = reference_logits
serve_decode.devtrace = SimpleNamespace(
    **{**vars(devtrace), "DeviceWindow": CountedWindow})
serve_decode.flops = SimpleNamespace(
    **{**vars(flops), "decode_flops": decode_flops})


def run(ctx: Ctx) -> Run:
    out = serve_decode.run(ctx)
    c = getattr(out.window, "counts", [])
    if len(c) == 2:
        out.data["moe_pairs"] = c[1][0] - c[0][0]
        out.data["moe_rows"] = c[1][1] - c[0][1]
        ctx.log(f"[serve_decode_granite] expert rows "
                f"{out.data['moe_rows']:.0f} for {out.data['moe_pairs']:.0f} "
                f"routed pairs in the window")
    return out
