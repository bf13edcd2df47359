"""Inject generated dry-run/roofline tables into EXPERIMENTS.md markers.

    PYTHONPATH=src python -m repro_torch.launch.inject_tables
"""
from __future__ import annotations

from repro_torch.launch.report import (dryrun_table, load, pick_hillclimb,
                                 roofline_table)


def main() -> None:
    baseline_rows = load("experiments/dryrun")
    v2_rows = load("experiments/dryrun_v2")

    dr = dryrun_table(baseline_rows)
    ro = roofline_table(v2_rows)
    pick = pick_hillclimb(load("experiments/dryrun"))

    with open("EXPERIMENTS.md") as f:
        text = f.read()
    text = text.replace("<!-- DRYRUN_TABLE -->", dr)
    text = text.replace("<!-- ROOFLINE_TABLE -->", ro)
    text = text.replace(
        "<!-- PICK_NOTE -->",
        "### Hillclimb-candidate selection (from the baseline sweep)\n\n"
        "```\n" + pick + "\n```\n")
    with open("EXPERIMENTS.md", "w") as f:
        f.write(text)
    print("tables injected:",
          f"{len(baseline_rows)} baseline rows, {len(v2_rows)} v2 rows")


if __name__ == "__main__":
    main()
