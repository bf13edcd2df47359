"""The checks that decide ``correct``: the reference and the port agree at
a small size, the control reads above the program, and a run with its
timed path broken underneath comes out not correct.

Run from the repository root: ``python -m pytest -q cacs_bench/tests``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cacs_bench import compare
from cacs_bench import weights as W
from cacs_bench.port import arch_config, param_shapes
from cacs_bench.reference import dense, int8
from cacs_bench.reference.tokens import batch_at, prompt

import bench_small


@pytest.mark.parametrize("cell,small", [("internlm2.swap", bench_small.train),
                                        ("jamba.serve", bench_small.serve)])
def test_reference_and_port_agree_in_float32(cell, small):
    """With the model in float32 the port's run and the plain reference
    meet to float32 rounding: every check reads ~0."""
    res = bench_small.run(cell, small("float32"))
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] < 1e-5, (name, c)


def test_token_rules_are_the_programs():
    from repro_torch.configs.internlm2_1_8b import CONFIG
    from repro_torch.data.pipeline import TokenPipeline
    seed = 2**31 + 99
    pipe = TokenPipeline(CONFIG, 3, 50, seed=seed)
    for step in (0, 7):
        want = pipe.batch_at(step)
        got = batch_at(seed, step, 3, 50, CONFIG.vocab_size)
        assert np.array_equal(got[0], want["tokens"])
        assert np.array_equal(got[1], want["targets"])
    rng = np.random.Generator(np.random.PCG64(seed))
    assert np.array_equal(prompt(seed, 4, 9, 100),
                          rng.integers(0, 100, (4, 9)).astype(np.int32))


def test_int8_roundtrip_is_the_codecs():
    from repro_torch.kernels.qsnap import (qsnap_dequantize,
                                           qsnap_quantize)
    g = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(1000, generator=g) * 3).to(dtype)
        codes, scales = qsnap_quantize(x)
        back = qsnap_dequantize(codes, scales, dtype)[:1000]
        assert torch.equal(back, int8.roundtrip(x))
        assert int8.gap_in_codes(back, x) == 0.0
        assert int8.gap_in_codes(int8.roundtrip(x, bits=4), x) > 3.0


def test_control_reads_above_the_program():
    """At a small size the float8 control's first-gradient gap to the
    float32 reference is over three times the bfloat16 program's."""
    res = bench_small.run("internlm2.swap", bench_small.train())
    from cacs_bench import harness
    found = harness.resolve(harness.benchmark(), "internlm2.swap")
    cfg, tr = found["config"], found["traffic"]
    small = bench_small.train()
    port = {**cfg["port"], **small["port"]}
    B, S = small["traffic"]["global_batch"], small["traffic"]["seq_len"]
    shapes = param_shapes(arch_config(port))
    batches = [batch_at(bench_small.SEED, k, B, S, port["vocab_size"])
               for k in range(3)]
    runs = {m: dense.train(W.draw(shapes, cfg["init"], bench_small.SEED,
                                  torch.device("cpu")), batches, port,
                           tr["optimizer"], mode=m)
            for m in ("f32", "fp8")}
    grad = compare.worst_leaf_gap(runs["fp8"]["grad1"], runs["f32"]["grad1"])
    assert grad > 3 * res["checks"]["grad1_gap"]["value"]


def _unchanged_step(orig):
    def make(model, opt_cfg, **kw):
        step = orig(model, opt_cfg, **kw)

        def unchanged(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return unchanged
    return make


def _half_batch_step(orig):
    def make(model, opt_cfg, **kw):
        step = orig(model, opt_cfg, **kw)

        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    return make


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    import repro_torch.train.trainer as T
    wrap = {"unchanged_state": _unchanged_step,
            "half_batch": _half_batch_step}[fault]
    monkeypatch.setattr(T, "make_train_step", wrap(T.make_train_step))
    small = bench_small.train()
    small["traffic"]["global_batch"] = 4
    res = bench_small.run("internlm2.swap", small)
    assert not res["correct"], res["checks"]


def test_a_broken_swap_is_not_correct(monkeypatch):
    """A restore that hands back the int8 codes' neighbour."""
    import repro_torch.kernels.qsnap as Q
    orig = Q.qsnap_dequantize_plain

    def off_by_one(codes, scales, dtype=torch.float32):
        return orig(torch.clamp(codes.int() + 1, -127, 127).to(torch.int8),
                    scales, dtype)
    monkeypatch.setattr(Q, "qsnap_dequantize_plain", off_by_one)
    res = bench_small.run("internlm2.swap", bench_small.train())
    assert not res["correct"], res["checks"]
    assert res["checks"]["swap_codes"]["value"] >= 1.0


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged",
                                   "half_batch"])
def test_a_broken_decode_is_not_correct(fault, monkeypatch):
    import repro_torch.serve.engine as E
    if fault == "token_altered":
        orig = E._greedy
        monkeypatch.setattr(E, "_greedy", lambda logits: (
            orig(logits) + 1) % logits.shape[-1])
    elif fault == "state_unchanged":
        orig_decode = E.Engine.decode

        def frozen(self, cache, token, pos):
            saved = {k: {n: t.clone() for n, t in v.items()}
                     for k, v in cache.items()}
            logits, _ = orig_decode(self, cache, token, pos)
            for k, v in saved.items():
                for n, t in v.items():
                    cache[k][n].copy_(t)
            return logits, cache
        monkeypatch.setattr(E.Engine, "decode", frozen)
    else:
        orig_decode = E.Engine.decode

        def half(self, cache, token, pos):
            logits, cache = orig_decode(self, cache, token, pos)
            n = logits.shape[0] // 2
            return torch.cat([logits[:n], logits[:n]])[:logits.shape[0]], \
                cache
        monkeypatch.setattr(E.Engine, "decode", half)
    res = bench_small.run("jamba.serve", bench_small.serve("float32"))
    assert not res["correct"], res["checks"]


def test_a_failed_prefill_ends_the_run_not_correct(monkeypatch):
    """A prefill that raises ends the job's thread without marking it
    unhealthy; the run still ends, and is not correct."""
    import repro_torch.serve.engine as E

    def fails(self, batch):
        raise ValueError("a prefill that fails")
    monkeypatch.setattr(E.Engine, "prefill", fails)
    res = bench_small.run("jamba.serve", bench_small.serve("float32"))
    assert not res["correct"]
    assert "ended at token 0" in res["error"]
