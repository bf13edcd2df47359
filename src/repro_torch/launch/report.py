"""Assemble EXPERIMENTS.md tables from experiments/dryrun/*.json.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024 or unit == "TB":
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}TB"


def fmt_s(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.1f}ms"
    return f"{s*1e6:.0f}us"


def load(dir_: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def dryrun_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | mesh | compile | bytes/dev (args+temp) | "
           "collective bytes/dev | status |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("tag"):
            continue
        mem = r.get("memory_analysis", {})
        live = mem.get("argument_size_in_bytes", 0)
        temp = mem.get("temp_size_in_bytes", 0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s', '—')}s | "
            f"{fmt_bytes(live)} + {fmt_bytes(temp)} | "
            f"{fmt_bytes(r['collectives']['total_bytes'])} | OK |")
    return "\n".join(out)


def roofline_table(rows: List[Dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | compute | memory (raw / fused / flash) | "
           "collective | bound | MODEL_FLOPS | useful ratio | "
           "roofline frac (raw / flash) |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r.get("tag"):
            continue
        ro = r["roofline"]
        mem = fmt_s(ro["memory_s"])
        if "memory_fused_s" in ro:
            mem += (f" / {fmt_s(ro['memory_fused_s'])} / "
                    f"{fmt_s(ro['memory_flash_s'])}")
        frac = f"{100*ro['roofline_fraction']:.2f}%"
        if "roofline_fraction_flash" in ro:
            frac += f" / {100*ro['roofline_fraction_flash']:.2f}%"
        dom = ro.get("dominant_flash", ro["dominant"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['compute_s'])} | "
            f"{mem} | {fmt_s(ro['collective_s'])} | "
            f"**{dom}** | {ro['model_flops']:.2e} | "
            f"{ro['useful_flops_ratio']:.3f} | {frac} |")
    return "\n".join(out)


def pick_hillclimb(rows: List[Dict], mesh: str = "16x16") -> str:
    cand = [r for r in rows if r["mesh"] == mesh and not r.get("tag")]
    if not cand:
        return ""
    worst = min(cand, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(cand, key=lambda r: (r["roofline"]["collective_s"]
                                    / max(r["roofline"]["step_bound_s"],
                                          1e-12)))
    return (f"worst roofline fraction: {worst['arch']}/{worst['shape']} "
            f"({100*worst['roofline']['roofline_fraction']:.2f}%)\n"
            f"most collective-bound:   {coll['arch']}/{coll['shape']} "
            f"(coll {fmt_s(coll['roofline']['collective_s'])} vs bound "
            f"{fmt_s(coll['roofline']['step_bound_s'])})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "pick"])
    args = ap.parse_args()
    rows = load(args.dir)
    if args.section in ("all", "dryrun"):
        print("## Dry-run matrix\n")
        print(dryrun_table(rows))
        print()
    if args.section in ("all", "roofline"):
        print("## Roofline (single-pod 16x16)\n")
        print(roofline_table(rows))
        print()
    if args.section in ("all", "pick"):
        print("## Hillclimb candidates\n")
        print(pick_hillclimb(rows))


if __name__ == "__main__":
    main()
