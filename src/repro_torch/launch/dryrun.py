"""Multi-pod dry run of the port: every (arch x shape) cell on the
production meshes, one rank's step traced on ``meta`` tensors in a
``fake``-backend world of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, its
roofline at H100 constants (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        internlm2-1.8b --shape train_4k --out /tmp/dr
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dr

Nothing is allocated and nothing runs on a GPU: the world is started
here (``fake_world``, the counterpart of the reference's 512 forced host
devices) and the cells are built on ``meta``. ``--all`` runs each cell
in a subprocess of its own (one process group a process; a crashing
cell does not take down the sweep) and prints OK, SKIP (with the reason)
or FAIL for each. The six ``long_500k`` cells of the sub-quadratic archs
(gemma3-12b, jamba-v0.1-52b, xlstm-125m, on both meshes) are traced:
their batch of 1 is replicated and the KV cache split over ``kvseq``
(``lowering``); the quadratic archs' ``long_500k`` cells SKIP by
``shape_applicable``, as in the reference. ``--seq-shard on|off``
splits the activations over the sequence between blocks or not; without
it a cell takes the reference's default (``lowering.default_seq_shard``:
on for the train and prefill of the attention archs), and its row
records ``seq_shard``. ``--remat-policy save_moe`` traces a train cell
under the reference's selective remat (``transformer.stack_forward``);
give it a ``--tag`` to keep its row beside the full-remat one:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        llama4-scout-17b-a16e --shape train_4k --remat-policy save_moe \
        --tag save_moe --out /tmp/dr
"""
import argparse
import json
import os
import subprocess
import sys
import time
from typing import Union

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, \
    shape_applicable

# a cell's subprocess exits with this code when the cell raised SkipCell
EXIT_SKIP = 3


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             remat: Union[bool, str] = True, fsdp=None, seq_shard=None,
             tag: str = "", full_compile: bool = True, rank: int = 0) -> dict:
    import torch.distributed as dist
    from repro_torch.launch.lowering import lower_and_analyze
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    if not dist.is_initialized():
        fake_world(512 if multi_pod else 256, rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta")
    cell_args = dict(arch=arch, shape=shape, remat=remat, fsdp=fsdp,
                     seq_shard=seq_shard)
    result = lower_and_analyze(cell_args, mesh, full_compile=full_compile)
    result["rank"] = dist.get_rank()
    if tag:
        result["tag"] = tag
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        mesh_tag = "2x16x16" if multi_pod else "16x16"
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape}_{mesh_tag}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def run_all(out_dir: str, multi_pod_list, jobs_filter=None) -> int:
    """Drive every (arch x shape x mesh) cell in a subprocess each."""
    failures = 0
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            ok, why = shape_applicable(cfg, SHAPES[shape_name])
            if not ok:
                print(f"SKIP  {arch:28s} {shape_name:12s} {why}")
                continue
            for mp in multi_pod_list:
                mesh_tag = "2x16x16" if mp else "16x16"
                if jobs_filter and (arch, shape_name, mesh_tag) not in jobs_filter:
                    continue
                path = os.path.join(
                    out_dir, f"{arch}_{shape_name}_{mesh_tag}.json")
                if os.path.exists(path):
                    print(f"HAVE  {arch:28s} {shape_name:12s} {mesh_tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--out", out_dir]
                if mp:
                    cmd.append("--multi-pod")
                t0 = time.monotonic()
                r = subprocess.run(cmd, capture_output=True, text=True)
                dt = time.monotonic() - t0
                if r.returncode == EXIT_SKIP:
                    why = r.stdout.strip().splitlines()[-1]
                    print(f"SKIP  {arch:28s} {shape_name:12s} {mesh_tag} "
                          f"{why}")
                elif r.returncode != 0:
                    failures += 1
                    print(f"FAIL  {arch:28s} {shape_name:12s} {mesh_tag} "
                          f"({dt:.0f}s)\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
                else:
                    print(f"OK    {arch:28s} {shape_name:12s} {mesh_tag} "
                          f"({dt:.0f}s)")
                sys.stdout.flush()
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on both meshes, "
                         "one subprocess per cell")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="",
                    help="selective remat, e.g. save_moe: each MoE "
                         "layer's dispatched rows and gathered expert "
                         "output kept for the backward")
    ap.add_argument("--fsdp", choices=["on", "off"])
    ap.add_argument("--seq-shard", choices=["on", "off"],
                    help="split activations over the sequence between "
                         "blocks (default: the reference's rule)")
    ap.add_argument("--tag", default="", help="variant tag for perf runs")
    ap.add_argument("--quick", action="store_true",
                    help="trace without the live-bytes tracker (no "
                         "memory_analysis)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the world whose step is traced")
    args = ap.parse_args()
    remat = args.remat_policy or (not args.no_remat)

    if args.all:
        failures = run_all(args.out, multi_pod_list=[False, True])
        sys.exit(1 if failures else 0)

    from repro_torch.launch.lowering import SkipCell
    fsdp = None if args.fsdp is None else args.fsdp == "on"
    seq_shard = None if args.seq_shard is None else args.seq_shard == "on"
    try:
        result = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                          remat=remat, fsdp=fsdp,
                          seq_shard=seq_shard, tag=args.tag,
                          full_compile=not args.quick, rank=args.rank)
    except SkipCell as e:
        print(e)
        sys.exit(EXIT_SKIP)
    head = {k: result.get(k) for k in
            ("arch", "shape", "mesh", "rank", "seq_shard", "trace_s")}
    print(json.dumps(head))
    if "memory_analysis" in result:
        print("memory_analysis:", json.dumps(result["memory_analysis"]))
    print("cost: flops/device=%.3e bytes/device=%.3e"
          % (result["flops_per_device"], result["bytes_per_device"]))
    print("collectives:", json.dumps(result["collectives"]))
    print("kernel calls:", json.dumps(result["kernel_calls"]))
    print("roofline:", json.dumps(result["roofline"]))


if __name__ == "__main__":
    main()
