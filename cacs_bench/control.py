"""Readings of a cell's checks on its control and its faults, on the card.

Not part of a benchmark run. Each seed prints one JSON line.

Training cell: the reference put in the program's place, computed in the
precision below the configuration's (``fp8``), and the reference with
half of each batch left out (``half``), both read by the numbers the
cell's check compares against the float32 reference:

    python3 cacs_bench/control.py --workload internlm2.swap --seeds 1,2,3

Serving cell: a whole run of the cell at its size and window, which then
also reads, over the same prompts and served tokens, the float32
reference's gap of the token that the float8 reference puts first:

    python3 cacs_bench/control.py --workload jamba.serve --seeds 1,2,3 \
        --seconds 51
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def train_readings(workload: str, seed: int, device) -> dict:
    import torch
    from cacs_bench import compare
    from cacs_bench import harness as H
    from cacs_bench import weights as W
    from cacs_bench.port import arch_config, param_shapes
    from cacs_bench.reference import dense, int8, lowp
    from cacs_bench.reference.tokens import batch_at

    found = H.resolve(H.benchmark(), workload)
    cfg, tr = found["config"], found["traffic"]
    port, opt = cfg["port"], tr["optimizer"]
    B, S = tr["global_batch"], tr["seq_len"]
    shapes = param_shapes(arch_config(port))
    batches = [batch_at(seed, k, B, S, port["vocab_size"])
               for k in range(tr["checked_steps"])]
    lowp.set_exact_matmul()
    runs = {}
    int4 = None
    for name, kw in (("ref", {"keep_state": True}), ("fp8", {"mode": "fp8"}),
                     ("half", {"rows": B // 2})):
        p0 = W.draw(shapes, cfg["init"], seed, device)
        runs[name] = dense.train(p0, batches, port, opt, **kw)
        if name == "ref":
            state = runs[name].pop("state")
            int4 = max(int8.gap_in_codes(int8.roundtrip(t, bits=4), t)
                       for t in state.values())
            del state
        del p0
        gc.collect()
        torch.cuda.empty_cache()
    ref = runs["ref"]
    moved = compare.moved_leaves(ref["grad1_raw"])
    out = {"seed": seed, "ref_losses": ref["losses"],
           "int4": {"swap_codes": int4}}
    for name in ("fp8", "half"):
        r = runs[name]
        out[name] = {
            "loss_gap": max(compare.rel_gap(g, w) for g, w in
                            zip(r["losses"], ref["losses"])),
            "grad1_gap": compare.worst_leaf_gap(r["grad1"], ref["grad1"]),
            "update_gap": compare.worst_leaf_gap(r["delta"], ref["delta"],
                                                 moved),
            "losses": r["losses"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args()
    from cacs_bench import harness as H
    H.set_run_env()
    sys.path.insert(0, str(H.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 2
    driver = H.resolve(H.benchmark(), args.workload)["traffic"]["driver"]
    for seed in (int(s) for s in args.seeds.split(",")):
        if driver == "train_swap":
            out = train_readings(args.workload, seed, torch.device("cuda"))
        else:
            res = H.run_cell(args.workload, seed, args.seconds, False,
                             extra={"control": True})
            out = {"seed": seed, "checks": res["checks"],
                   "readings": res.get("readings"),
                   "correct": res["correct"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
