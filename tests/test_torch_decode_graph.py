"""The decode step at a ``pos`` held on the device, on the CPU: what a
decode step captured in a CUDA graph computes (``serve.engine.Engine``
replays it on a card).

A 0-d int32 ``pos`` gives the int ``pos``'s logits and cache bit for bit
for a dense GQA model, a hybrid one (Mamba, MoE and attention) and one
with windowed layers; a mirror of the decode kernel's on-device split
(``csrc/decode_attention.cu`` with ``pos_dev``) equals ``decode_plan`` at
every ``pos``; a captured step's key changes with every cache tensor's
layout and the token's, not only with their addresses; on the CPU
``Engine.decode`` never captures; and what ``Model.decode_counts`` lists
for reduced jamba, granite and gemma3 is what an eager decode step adds
to (a replay adds those counts, the step's Python not running).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.obs import Tracer, use_registry, use_tracer
from repro_torch.obs.telemetry import registry
from repro_torch.serve.engine import Engine, ServeApp, _graph_key

ARCHS = ["internlm2-1.8b", "jamba-v0.1-52b", "gemma3-12b"]


def _clone(cache):
    return {k: {kk: t.clone() for kk, t in v.items()}
            for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_device_pos_decode_equals_int_pos_bit_for_bit(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=20)
    if arch == "gemma3-12b":
        assert any(blk.kind == "attn" and blk.spec.window is not None
                   for blk in model.blocks)
    by_int, by_dev = _clone(cache), _clone(cache)
    tok = torch.argmax(logits, -1)[:, None]
    for pos in range(12, 18):
        li, by_int = model.decode_step(params, by_int, tok, pos)
        ld, by_dev = model.decode_step(
            params, by_dev, tok, torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(li, ld), pos
        for name in by_int:
            for kk in by_int[name]:
                assert torch.equal(by_int[name][kk], by_dev[name][kk]), \
                    (pos, name, kk)
        tok = torch.argmax(li, -1)[:, None]


def _kernel_plan(B, Hkv, g, pos):
    """The decode kernel's split with ``pos`` on the device, as its C
    computes it: on a grid of ``plan_split``'s ``want`` chunks, each
    block's chunk size and count from ``pos`` (integer division of
    non-negative ints)."""
    _, _, want = DA.plan_split(B, Hkv, g)
    slots = pos + 1
    chunk = (slots + want - 1) // want
    chunk = max(64, (chunk + 64 - 1) // 64 * 64)
    return chunk, (slots + chunk - 1) // chunk, want


# (B, Hkv, g, T): jamba's served cell (32 rows, 8 kv heads of 4 q heads,
# 4,352 slots), repro-100m's served step and the long decode of the card
# tests, and one q head over one kv head
PLAN_SHAPES = [(32, 8, 4, 4352), (8, 4, 3, 32768), (1, 1, 1, 4096)]


@pytest.mark.parametrize("B,Hkv,g,T", PLAN_SHAPES)
def test_kernel_device_split_equals_decode_plan(B, Hkv, g, T):
    for pos in range(T):
        plan = DA.decode_plan(B, Hkv, g, pos)
        chunk, n_chunks, want = _kernel_plan(B, Hkv, g, pos)
        assert (chunk, n_chunks) == (plan.chunk, plan.n_chunks), pos
        assert n_chunks <= want


def test_engine_on_the_cpu_never_captures():
    """``Engine.decode`` and a ``ServeApp`` on the CPU decode eagerly: no
    capture, replay or fallback is counted, and no ``serve/dispatch``
    span carries ``graph``."""
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                              dtype="float32")
    names = ("serve.decode_graph_captures", "serve.decode_graph_replays",
             "serve.decode_graph_fallbacks")
    before = [registry().value(n) for n in names]
    tr = Tracer()
    with use_tracer(tr):
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                               generator=torch.Generator().manual_seed(1))
        out = Engine(model, params, cache_len=16).generate(
            {"tokens": tokens}, 4)
        app = ServeApp(cfg, batch=2, prompt_len=8, n_tokens=4, cache_len=16,
                       device="cpu")
        app.start(None, None)
        app._thread.join(timeout=120)
    assert out.shape == (2, 4) and app.healthy() and app.generated == 4
    assert [registry().value(n) for n in names] == before
    spans = tr.spans(name="serve/dispatch")
    assert len(spans) == 3 + 3
    assert not any("graph" in sp.args for sp in spans)


def test_graph_key_follows_each_cache_tensors_layout():
    """Two caches at the same addresses key one graph only where every
    tensor has the same shape, strides and dtype, and the token too: an
    enc-dec cache's cross-attention memory over a shorter source may land
    where a freed longer one was."""
    k = torch.zeros(4, 2, 24, 2, 32)
    mk = torch.zeros(4 * 2 * 8 * 2 * 32)
    tok = torch.zeros(2, 1, dtype=torch.int32)

    def key(mem, token=tok):
        return _graph_key({"attn": {"k": k}, "xattn": {"mk": mem}}, token)
    base = key(mk.view(4, 2, 8, 2, 32))
    assert key(mk.view(4, 2, 8, 2, 32)) == base
    for other in (key(mk[:4 * 2 * 4 * 2 * 32].view(4, 2, 4, 2, 32)),
                  key(mk.view(4, 2, 2, 8, 32).transpose(2, 3)),
                  key(mk.view(torch.float16).view(4, 2, 16, 2, 32)),
                  key(mk.view(4, 2, 8, 2, 32), tok.long()),
                  key(mk.view(4, 2, 8, 2, 32), tok.view(1, 2))):
        assert other != base


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-4.0-h-small",
                                  "gemma3-12b"])
def test_decode_counts_are_what_a_decode_step_counts(arch):
    """``Model.decode_counts`` lists the MoE dispatch's counters where the
    model has MoE blocks, the windowed layers' counter where it has
    windowed attention, and the decode kernel's launches where it has
    attention without a window; each of two eager decode steps adds to
    every listed registry counter and to no other counter of the
    registry."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg)
    attn = [blk.spec.window is not None for blk in model.blocks
            if blk.kind == "attn"]
    counts = model.decode_counts()
    listed = counts.counters
    assert all(c in listed for c in M.COUNTERS) == \
        any(blk.kind == "moe" for blk in model.blocks)
    assert (L.WINDOW_REF_DECODES in listed) == any(attn)
    assert (L.DECODE_LAUNCHES in listed) == (not all(attn))
    names = {c for c in listed if isinstance(c, str)}
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=16)
    tok = torch.argmax(logits, -1)[:, None]
    with use_registry() as reg:
        for pos in (12, 13):
            before = {n: reg.value(n) for n in reg.names()}
            listed_before = counts.read()
            logits, cache = model.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits, -1)[:, None]
            moved = {n for n in reg.names()
                     if reg.value(n) != before.get(n, 0.0)}
            assert moved == names, (pos, moved)
            added = [a - b for a, b in zip(counts.read(), listed_before)]
            assert all(n > 0 for c, n in zip(listed, added)
                       if isinstance(c, str)), added
