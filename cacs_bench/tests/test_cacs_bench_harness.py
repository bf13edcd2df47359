"""The harness finds everything by name, a cell or metric added as files
is picked up, the operation and byte counts match hand counts, a result
line has the contract's keys, and nothing loads JAX or the JAX package.

Run from the repository root: ``python -m pytest -q cacs_bench/tests``.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cacs_bench import devtrace, flops, harness
from cacs_bench.port import arch_config, param_shapes

import bench_small

ROOT = Path(__file__).resolve().parents[2]
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "num_experts_per_tok", "mamba_d_state",
          "mamba_expand", "mamba_dt_rank", "mamba_d_conv")


def test_every_name_resolves():
    bench = harness.benchmark()
    used = set()
    for cell in bench["workloads"]:
        found = harness.resolve(bench, cell["name"])
        assert found["driver"].is_file()
        assert set(found["limits"]) and all(
            v >= 0 for v in found["limits"].values())
        used.add(cell["config"])
        for trace in (False, True):
            ms = harness.metrics_for(bench, cell["name"], trace)
            assert ms, (cell["name"], trace)
            for m in ms:
                assert callable(harness.reader(m["name"]).read)
        names = [m["name"] for m in harness.metrics_for(
            bench, cell["name"], False)]
        assert "setup_s" in names and len(names) >= 2
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
            assert key in cfg.get("reduced_from", {}), key


def test_a_cell_and_a_metric_added_as_files(tmp_path, monkeypatch):
    bench_dir = tmp_path / "cacs_bench"
    shutil.copytree(harness.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    (bench_dir / "traffic" / "swap20-2x2048.json").write_text(json.dumps(
        {**json.loads((bench_dir / "traffic" / "swap1-4x4096.json")
                      .read_text()),
         "global_batch": 2, "seq_len": 2048}))
    (bench_dir / "limits" / "internlm2.swap20.json").write_text(
        (bench_dir / "limits" / "internlm2.swap.json").read_text())
    (bench_dir / "metrics" / "steps_kept.swap20.py").write_text(
        "def read(run):\n    return run.data['progress_steps']\n")
    bench["workloads"].append({"name": "internlm2.swap20",
                               "config": "internlm2-1.8b.8l",
                               "traffic": "swap20-2x2048", "chips": 1,
                               "why": "a cell added as data"})
    bench["per_layer"].append({"name": "steps_kept.swap20", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "application",
                               "moves": "train_tokens_per_s",
                               "workloads": ["internlm2.swap20"]})
    monkeypatch.setattr(harness, "BENCH", bench_dir)
    found = harness.resolve(bench, "internlm2.swap20")
    assert found["traffic"]["seq_len"] == 2048
    assert found["driver"] == bench_dir / "drivers" / "train_swap.py"
    ms = [m["name"] for m in harness.metrics_for(bench, "internlm2.swap20",
                                                 True)]
    assert ms == ["steps_kept.swap20"]
    run = harness.Run(data={"progress_steps": 7}, checks=[], attempted=0,
                      failed=0, memory_peak_bytes=0)
    assert harness.reader("steps_kept.swap20").read(run) == 7
    assert "internlm2.swap20" not in [
        c["name"] for c in harness.benchmark()["workloads"]]


def _cfg(name):
    bench = harness.benchmark()
    entry = {c["name"]: c for c in bench["configs"]}[name]
    return json.loads((ROOT / entry["file"]).read_text())["port"]


def test_flop_and_byte_counts_by_hand():
    port = _cfg("internlm2-1.8b.8l")
    shapes = param_shapes(arch_config(port))
    d, f, V = 2048, 8192, 92672              # the vocab padded to 256
    layer = d * 16 * 128 + 2 * d * 8 * 128 + 16 * 128 * d + 3 * d * f + 2 * d
    n = 8 * layer + d * V + d                # + output head + final norm
    assert sum(math.prod(s) for k, (s, _) in shapes.items()
               if k != "embed.embedding") == n
    assert flops.train_flops_per_token(shapes, port, 4096) == \
        6 * n + 12 * 8 * 16 * 128 * 4096
    port = _cfg("jamba-v0.1-52b.period")
    shapes = param_shapes(arch_config(port))
    d, f, di, V = 4096, 14336, 8192, 65536
    attn = d * 32 * 128 + 2 * d * 8 * 128 + 32 * 128 * d + d
    mamba = (d * 2 * di + 4 * di + di + di * (256 + 32) + 256 * di + di
             + di * 16 + di + di * d + d)
    mlp = 3 * d * f + d
    moe_active = d * 16 + 2 * 3 * d * f + d
    active = attn + 7 * mamba + 4 * mlp + 4 * moe_active + d * V + d
    assert flops.active_params(shapes, port) == active
    assert flops.decode_flops(shapes, port, 32, 999) == \
        32 * (2 * active + 4 * 32 * 128 * 1000)
    assert flops.qsnap_quant_bytes(300, 4) == 1200 + 512 + 8
    assert flops.qsnap_dequant_bytes(300, 2) == 512 + 8 + 1024
    assert flops.decode_attn_bytes(32, 32, 8, 128, 999) == \
        2 * (2 * 32 * 8 * 128 * 1000 + 2 * 32 * 32 * 128)
    assert flops.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert flops.bf16_peak() == 989e12


def test_device_trace_reduction():
    w = devtrace.DeviceWindow(False)
    w.t_open, w.t_close = 0, 100
    w.events = [("a", -5, 10), ("b", 5, 20), ("a", 40, 50), ("c", 90, 120)]
    assert w.busy() == [(0, 20), (40, 50), (90, 100)]
    assert w.busy_s() == 40e-9
    assert w.idle_gaps(lambda s, e: f"{s}-{e}") == [["50-90", 40e-9],
                                                    ["20-40", 20e-9]]
    assert w.device_ops()[0] == ["c", 30e-9]
    assert devtrace.kernel_name(
        "void (anonymous namespace)::decode_kernel<__nv_bfloat16, 128>"
        "(__nv_bfloat16 const*)") == "decode_kernel"
    assert devtrace.kernel_name(
        "void qsnap_quantize_kernel<float>(float const*, long long)") == \
        "qsnap_quantize_kernel"


@pytest.mark.parametrize("cell,small", [("internlm2.swap", bench_small.train),
                                        ("jamba.serve", bench_small.serve)])
def test_result_line_keys(cell, small):
    res = bench_small.run(cell, small())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_chip_no_result():
    out = subprocess.run(
        [sys.executable, "cacs_bench/run.py", "--workload", "jamba.serve",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_nothing_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['.', 'src'];"
        "from cacs_bench import harness, control;"
        "from pathlib import Path;"
        "[harness.load_module(p) for p in Path('cacs_bench/drivers')"
        ".glob('*.py')];"
        "[harness.load_module(p) for p in Path('cacs_bench/metrics')"
        ".glob('*.py')];"
        "import repro_torch.core, repro_torch.train.trainer,"
        " repro_torch.serve.engine;"
        "print(','.join(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
    code = ("import sys; sys.path[:0] = ['.'];"
            "import cacs_bench.reference.dense, cacs_bench.reference.hybrid,"
            " cacs_bench.reference.int8, cacs_bench.reference.tokens;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_cells_on_the_card_at_a_small_size():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells measure the card")
    from cacs_bench.harness import run_cell
    for cell, small in (("internlm2.swap", bench_small.train),
                        ("jamba.serve", bench_small.serve)):
        over = small("float32")
        over["port"]["d_model"] = 128    # head dim 32: the kernels take it
        if cell == "jamba.serve":        # enough steps to outlast the window
            over["traffic"].update(n_tokens=3000, cache_len=3072)
        res = run_cell(cell, bench_small.SEED, 2.0, True, overrides=over)
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu"
        assert res["device"]["busy_s"] > 0
        assert all(c["value"] < 1e-3 for n, c in res["checks"].items()
                   if n != "swap_codes"), res["checks"]


def test_roofline_readers_on_a_made_up_trace():
    """Each reader takes its kernel's launches from the window and sets
    the bytes they move against their summed time; a window without
    them reads nothing."""
    w = devtrace.DeviceWindow(False)
    w.t_open, w.t_close = 0, 10**9
    leaves = [(1000, 4), (300, 2)]
    w.events = [("qsnap_quantize_kernel", 0, 2000),
                ("qsnap_quantize_kernel", 5000, 6000),
                ("qsnap_quantize_kernel", 9000, 9500)]   # a pass cut short
    run = harness.Run(data={"float_leaves": leaves,
                            "device_kind": "NVIDIA H100 80GB HBM3"},
                      checks=[], attempted=0, failed=0, memory_peak_bytes=0,
                      window=w)
    moved = flops.qsnap_quant_bytes(1000, 4) + flops.qsnap_quant_bytes(300, 2)
    want = 100.0 * moved / 3.35e12 / 3000e-9
    assert harness.reader("qsnap_quant_roofline.swap").read(run) == \
        pytest.approx(want)
    assert harness.reader("qsnap_dequant_roofline.swap").read(run) is None
    run.data.update(attn=(32, 32, 8, 128), decode_pos0=999)
    w.events = [("decode_kernel", 0, 4000), ("decode_kernel", 9000, 13000)]
    least = sum(flops.decode_attn_bytes(32, 32, 8, 128, p) / 3.35e12
                for p in (999, 1000))
    assert harness.reader("decode_attn_roofline.serve").read(run) == \
        pytest.approx(100.0 * least / 8000e-9)
