"""The ``granite.serve`` cell cut to a size the CPU runs in seconds: one
untraced run is correct and reports its end-to-end metrics, and the
readers of its two per-layer metrics read the run's counters and the
program's spans (and nothing where they are absent)."""
from __future__ import annotations

from bench_small import SEED


def small(dtype: str = "float32") -> dict:
    return {"port": {"n_layers": 8, "d_model": 64, "n_heads": 4,
                     "n_kv_heads": 2, "d_ff": 48, "vocab_size": 256,
                     "attn_every": 4, "attn_offset": 1, "attn_scale": 0.0625,
                     "ssm": {"d_state": 16, "d_conv": 4, "expand": 2,
                             "n_heads": 8, "head_dim": 16, "n_groups": 1,
                             "chunk": 16},
                     "moe": {"num_experts": 8, "top_k": 2, "d_ff": 32,
                             "every": 1, "shared_expert": True,
                             "capacity_factor": None},
                     "dtype": dtype},
            "traffic": {"batch": 4, "prompt_len": 24, "n_tokens": 60,
                        "cache_len": 96, "warm_steps": 2}}


def test_granite_cell_runs_small_and_correct():
    """float32 throughout: the served tokens are the reference's argmax."""
    from cacs_bench import harness as H
    res = H.run_cell("granite.serve", SEED, 1.5, False, require_chip=False,
                     overrides=small())
    assert res["correct"] and res["failed"] == 0, res
    assert set(res["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert res["checks"]["served_gap_mean"]["value"] < 1e-3


def test_granite_readers():
    from cacs_bench import harness as H
    from repro_torch.obs import Tracer, use_tracer
    rows = H.reader("moe_rows_per_pair.granite")
    run = lambda data: H.Run(data, [], 0, 0, 0)
    assert rows.read(run({"moe_pairs": 640.0, "moe_rows": 640.0})) == 1.0
    assert rows.read(run({"moe_pairs": 640.0, "moe_rows": 18432.0})) == 28.8
    assert rows.read(run({})) is None
    assert rows.read(run({"moe_pairs": 0.0, "moe_rows": 0.0})) is None
    prefill = H.reader("prefill_mamba2_ms.granite")
    with use_tracer(Tracer()) as tr:
        assert prefill.read(None) is None
        for ms in (1.5, 2.0):
            with tr.span("prefill/mamba2", cat="serve") as sp:
                sp.set("device_ms", ms)
        with tr.span("prefill/mamba2", cat="serve"):
            pass                    # no device time off the card
        assert prefill.read(None) == 3.5
