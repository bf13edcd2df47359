"""Cells cut to a size the CPU runs in seconds (for the tests only)."""
from __future__ import annotations

SEED = 2**31 + 12345


def train(dtype: str = "bfloat16") -> dict:
    return {"port": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                     "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
                     "dtype": dtype},
            "traffic": {"global_batch": 2, "seq_len": 32}}


def serve(dtype: str = "bfloat16") -> dict:
    return {"port": {"n_layers": 8, "d_model": 64, "n_heads": 4,
                     "n_kv_heads": 2, "d_ff": 96, "vocab_size": 256,
                     "ssm": {"d_state": 4, "d_conv": 4, "expand": 2},
                     "moe": {"num_experts": 4, "top_k": 2, "d_ff": 48,
                             "every": 2, "capacity_factor": 1.25},
                     "dtype": dtype},
            "traffic": {"batch": 4, "prompt_len": 16, "n_tokens": 120,
                        "cache_len": 160, "warm_steps": 2}}


def run(cell: str, overrides: dict, seconds: float = 2.0,
        seed: int = SEED) -> dict:
    from cacs_bench.harness import run_cell
    return run_cell(cell, seed, seconds, False, require_chip=False,
                    overrides=overrides)
