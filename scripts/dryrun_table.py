#!/usr/bin/env python3
"""The port's dry-run sweep as one markdown table, a row per live cell.

Reads the JSON rows that ``python -m repro_torch.launch.dryrun --all
--out DIR`` writes (one rank's step of each cell traced on ``meta``
tensors, mesh (16, 16) and (2, 16, 16)) and prints, per (arch, shape),
both meshes' numbers as "16x16 / 2x16x16": argument + temp bytes a rank
in GB and whether they fit one 80 GB H100, whether the activations are
split over the sequence between blocks (``seq_shard``), the three
roofline terms at
the H100 data-sheet constants of ``repro_torch.launch.analysis`` (the
memory term unfused, and fused with the attention scores kept on chip),
``dominant`` and ``useful_flops_ratio``. Every number is arithmetic on
the trace and the constants, not a measurement.

    PYTHONPATH=src python3 scripts/dryrun_table.py --dir /tmp/dr
"""
import argparse
from collections import defaultdict

from repro_torch.launch.report import load

HBM_BYTES = 80e9          # one H100's HBM3
MESHES = ("16x16", "2x16x16")


def by_cell(rows):
    """``report.load``'s rows (tagged variants left out) by (arch, shape),
    then by mesh."""
    cells = defaultdict(dict)
    for r in rows:
        if not r.get("tag"):
            cells[(r["arch"], r["shape"])][r["mesh"]] = r
    return cells


def _live(r) -> float:
    ma = r["memory_analysis"]
    return ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]


COLUMNS = (
    ("args + temp GB a rank", lambda r: f"{_live(r) / 1e9:.1f}"),
    ("fits 80 GB", lambda r: "yes" if _live(r) <= HBM_BYTES else "no"),
    ("seq_shard", lambda r: "on" if r.get("seq_shard") else "off"),
    ("compute s", lambda r: f"{r['roofline']['compute_s']:.3g}"),
    ("memory s", lambda r: f"{r['roofline']['memory_s']:.3g}"),
    ("memory s, flash", lambda r: f"{r['roofline']['memory_flash_s']:.3g}"),
    ("collective s", lambda r: f"{r['roofline']['collective_s']:.3g}"),
    ("dominant", lambda r: r["roofline"]["dominant"]),
    ("useful ratio", lambda r: f"{r['roofline']['useful_flops_ratio']:.3f}"),
)


def table(cells) -> str:
    out = ["| arch | shape | " + " | ".join(c for c, _ in COLUMNS) + " |",
           "|---|---|" + "---|" * len(COLUMNS)]
    for (arch, shape), rows in cells.items():
        vals = [" / ".join(fn(rows[m]) if m in rows else "—"
                           for m in MESHES) for _, fn in COLUMNS]
        out.append(f"| {arch} | {shape} | " + " | ".join(vals) + " |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    print(table(by_cell(load(ap.parse_args().dir))))


if __name__ == "__main__":
    main()
