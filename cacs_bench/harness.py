"""Runs one cell of the benchmark once and prints its result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration file; its traffic file
``cacs_bench/traffic/<traffic>.json``, which names the driver
``cacs_bench/drivers/<driver>.py``; the limits of its correctness checks
``cacs_bench/limits/<cell>.json``; and one reader
``cacs_bench/metrics/<metric>.py`` for every metric the cell reports.
Adding a cell, a configuration or a metric adds files; no file here
changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Ctx:
    """What a driver is handed: the cell's files, the run's arguments,
    and the clock of the process's start."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                      # time.monotonic() at process start
    log: Callable[[str], None]
    extra: dict = dataclasses.field(default_factory=dict)
    marks: List[tuple] = dataclasses.field(default_factory=list)

    def mark(self, stage: str) -> None:
        """The end of a stage of set-up (the last one opens the window)."""
        self.marks.append((stage, time.monotonic()))


@dataclasses.dataclass
class Run:
    """What a driver hands back. ``data`` is what the metric readers
    read; ``checks`` decide ``correct``."""
    data: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    window: Any = None                  # devtrace.DeviceWindow
    label: Optional[Callable[[int, int], str]] = None
    error: Optional[str] = None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    name = "cacs_bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry and the files it names, found by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell named {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    entry = cfgs[cell["config"]]
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return {
        "cell": cell,
        "config": load_json(root / entry["file"]),
        "traffic": traffic,
        "driver": BENCH / "drivers" / f"{traffic['driver']}.py",
        "limits": load_json(BENCH / "limits" / f"{workload}.json"),
    }


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end metrics untraced,
    its per-layer metrics traced."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def process_start() -> float:
    """``time.monotonic()`` at this process's start, from /proc."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def set_run_env() -> None:
    """The run's environment, set before torch is imported. Build and
    kernel caches inside the checkout, at fixed paths, so a second run of
    a cell finds every kernel built (the port's own nvcc builds go to
    ``src/repro_torch/_build/``, also inside it). The CUDA caching
    allocator grows segments in place rather than keeping blocks of fixed
    sizes: a training job holds three copies of its state at once in a
    swap-out, and with fixed segments the blocks freed by one step do not
    fit the next (internlm2-1.8b at all 24 layers ran out of memory with
    gigabytes reserved and unused)."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_info(torch, count: int) -> dict:
    import subprocess
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: Any = None, require_chip: bool = True,
             overrides: Optional[dict] = None,
             t_start: Optional[float] = None,
             extra: Optional[dict] = None) -> dict:
    """Run the cell once; return the result object (not printed).

    ``overrides`` (tests) replaces entries of the resolved files:
    ``{"port": {...}, "traffic": {...}}``.
    """
    t_start = process_start() if t_start is None else t_start
    set_run_env()
    sys.path.insert(0, str(ROOT / "src"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    bench = benchmark()
    found = resolve(bench, workload)
    cfg, traffic = found["config"], dict(found["traffic"])
    if overrides:
        cfg = {**cfg, "port": {**cfg["port"], **overrides.get("port", {})}}
        traffic.update(overrides.get("traffic", {}))
    import torch
    if require_chip:
        if not torch.cuda.is_available():
            raise NoChip("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < found["cell"]["chips"]:
            raise NoChip(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell asks for {found['cell']['chips']}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device or "cpu")
    ctx = Ctx(cell=found["cell"], config=cfg, traffic=traffic,
              limits=found["limits"], seed=seed, seconds=seconds,
              trace=trace, device=device, t_start=t_start, log=log,
              extra=extra or {})
    ctx.mark("imports")
    run: Run = load_module(found["driver"]).run(ctx)
    t = t_start
    stages = []
    for stage, t_end in ctx.marks:
        stages.append(f"{stage} {t_end - t:.2f}")
        t = t_end
    log(f"[{workload}] set-up s: " + ", ".join(stages))
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in the run's process: {bad}")
    if device.type == "cuda":               # read after the window: no set-up
        info = card_info(torch, found["cell"]["chips"])
    else:
        info = {"platform": device.type, "kind": "not a card", "count": 0}
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info["memory_peak_bytes"] = run.memory_peak_bytes
    result = {"correct": run.error is None and all(c.ok for c in run.checks),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": info}
    if trace and run.window is not None and run.window.t_close is not None:
        info["busy_s"] = run.window.busy_s()
        info["window_s"] = run.window.window_s
        result["breakdown"] = {
            "device_ops": run.window.device_ops(),
            "idle_gaps": run.window.idle_gaps(run.label or (
                lambda s, e: "host"))}
    if run.error:
        result["error"] = run.error[-1500:]
    if extra:
        result["readings"] = run.data.get("control", {})
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in run.checks}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=t_start)
    except NoChip as e:
        log(f"cacs_bench: {e}")
        return 2
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
