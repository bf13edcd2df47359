"""Operations and bytes of the work a cell's window drives, computed from
the shapes it was given, and the chip's peaks (``peaks.json``)."""
from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
QSNAP_BLOCK = 256

Shapes = Dict[str, Tuple[Tuple[int, ...], object]]


def bf16_peak() -> float:
    return float(PEAKS["bf16_flops_per_s"])


def hbm_peak(kind: str) -> float:
    for name, rate in PEAKS["hbm_bytes_per_s"]:
        if name in kind:
            return float(rate)
    return float(PEAKS["hbm_bytes_per_s"][-1][1])


def numel(shape: Iterable[int]) -> int:
    return math.prod(shape)


def _is_expert(name: str) -> bool:
    return name.rsplit(".", 1)[-1].startswith("we_")


def train_flops_per_token(shapes: Shapes, port: dict, seq: int) -> float:
    """Model FLOPs a trained token, without recompute: 6 N plus the
    attention's 12 L H hd S, N the parameters but the input embedding
    (the output head counted)."""
    n = sum(numel(s) for name, (s, _) in shapes.items()
            if name != "embed.embedding")
    hd = port.get("head_dim") or port["d_model"] // port["n_heads"]
    n_attn = sum(1 for j in range(port["n_layers"])
                 if j % port.get("attn_every", 1) == 0)
    return 6.0 * n + 12.0 * n_attn * port["n_heads"] * hd * seq


def active_params(shapes: Shapes, port: dict) -> float:
    """Parameters a decoded token reads through its matmuls: every leaf
    but the input embedding, an expert leaf at top_k of its experts."""
    total = 0.0
    for name, (s, _) in shapes.items():
        if name == "embed.embedding":
            continue
        frac = (port["moe"]["top_k"] / port["moe"]["num_experts"]
                if _is_expert(name) else 1.0)
        total += numel(s) * frac
    return total


def decode_flops(shapes: Shapes, port: dict, batch: int, pos: int) -> float:
    """One decode step of ``batch`` tokens at slot ``pos``: 2 x active
    parameters a token, and 4 H hd (pos + 1) a token an attention layer
    (scores and the weighted sum over the cache)."""
    hd = port.get("head_dim") or port["d_model"] // port["n_heads"]
    n_attn = sum(1 for j in range(port["n_layers"])
                 if j % port.get("attn_every", 1) == 0)
    per_tok = (2.0 * active_params(shapes, port)
               + 4.0 * n_attn * port["n_heads"] * hd * (pos + 1))
    return batch * per_tok


def qsnap_quant_bytes(n: int, elsize: int) -> int:
    """A quantize launch over ``n`` values: each read once, the padded
    int8 codes and the f32 block scales written once."""
    padded = -(-n // QSNAP_BLOCK) * QSNAP_BLOCK
    return n * elsize + padded + 4 * (padded // QSNAP_BLOCK)


def qsnap_dequant_bytes(n: int, elsize: int) -> int:
    """A dequantize launch: codes and scales read, ``padded`` values of
    the leaf's dtype written."""
    padded = -(-n // QSNAP_BLOCK) * QSNAP_BLOCK
    return padded + 4 * (padded // QSNAP_BLOCK) + padded * elsize


def decode_attn_bytes(batch: int, n_heads: int, n_kv: int, hd: int,
                      pos: int, elsize: int = 2) -> int:
    """A decode-attention launch at slot ``pos``: K and V slots 0..pos
    read once, q read and the output written."""
    return elsize * (2 * batch * n_kv * hd * (pos + 1)
                     + 2 * batch * n_heads * hd)


def qsnap_roofline(run, pattern: str, nbytes) -> Optional[float]:
    """A qsnap kernel's share of its roofline over the window's complete
    passes over the state (one launch a float leaf): the least time its
    bytes take at the card's HBM rate over the kernel's summed device
    time, in %."""
    w = run.window
    if w is None or w.t_close is None:
        return None
    rx = re.compile(pattern)
    times = [e - s for n, s, e in w.events if rx.search(n)]
    leaves = run.data["float_leaves"]
    whole = len(times) // len(leaves)
    if whole == 0:
        return None
    sec = sum(times[:whole * len(leaves)]) / 1e9
    moved = whole * sum(nbytes(n, size) for n, size in leaves)
    return 100.0 * moved / hbm_peak(run.data["device_kind"]) / sec

