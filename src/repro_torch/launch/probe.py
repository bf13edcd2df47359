"""Perf-iteration probe (port of ``repro/launch/probe.py``): one rank's
step of a depth-k cell traced on ``meta`` tensors in a 256-rank ``fake``
world, its cost (FLOPs, bytes, the fused and flash byte counts of
``analysis.fused_memory_bytes``) and its top collectives by bytes with
their call sites — the dry-run counterpart of a profiler trace.
``--seq-shard on|off`` overrides ``build_cell``'s default;
``--remat-policy save_moe`` takes the selective remat (as the dry run's
flag); ``--sites`` adds each call site's link bytes and its share of the
step's (``analysis.link_bytes_by_site``).

    PYTHONPATH=src python -m repro_torch.launch.probe --arch \
        llama4-scout-17b-a16e --shape train_4k --depth 2
"""
import argparse
import json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--fsdp", choices=["on", "off"])
    ap.add_argument("--seq-shard", choices=["on", "off"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="",
                    help="selective remat, e.g. save_moe")
    ap.add_argument("--sites", action="store_true",
                    help="link bytes by call site, with shares")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.launch import analysis
    from repro_torch.launch.lowering import _trace_cell, build_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    fake_world(256, args.rank)
    mesh = make_production_mesh(device_type="meta")
    fsdp = None if args.fsdp is None else args.fsdp == "on"
    seq_shard = None if args.seq_shard is None else args.seq_shard == "on"
    cell = build_cell(args.arch, args.shape, mesh, depth_groups=args.depth,
                      remat=args.remat_policy or not args.no_remat,
                      fsdp=fsdp,
                      seq_shard=seq_shard)
    res = _trace_cell(cell, track_memory=False)
    print(json.dumps({
        "seq_shard": cell.seq_shard,
        "flops": res["cost"]["flops"],
        "bytes": res["cost"]["bytes accessed"],
        "fused": res["fused"],
        "collectives": {k: v for k, v in res["collectives"].items() if v},
        "kernels": res["kernels"],
        # what fused_flash_bytes leaves out, by score shape
        "left_out": {str(k): v for k, v in res["left_out"].items()},
    }, indent=1))
    print("\ntop collectives (bytes in all, op, call site, count):")
    for nbytes, op, where, count in analysis.top_collectives(res["log"],
                                                             args.top):
        print(f"  {nbytes/1e6:10.1f}MB  {op:12s} x{count:<5d} {where}")
    if args.sites:
        total = res["collectives"]["total_link_bytes"]
        print(f"\nlink bytes by call site (of {total} in all):")
        for where, n in analysis.link_bytes_by_site(res["log"]):
            print(f"  {n:16d}  {n / total:7.4f}  {where}")


if __name__ == "__main__":
    main()
