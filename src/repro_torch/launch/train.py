"""Training launcher (port of ``repro/launch/train.py``).

Two modes:
  * ``--managed``  — submit the job to a CACS service instance (checkpoint
    policy, health monitoring, failure recovery all owned by the service —
    the paper's deployment model): submit, periodic checkpoints, an
    explicit checkpoint, a restart from it, then run to the end.
  * raw           — plain loop with an AsyncCheckpointer (for debugging);
    ``--resume`` restores the newest image first.

    python -m repro_torch.launch.train --managed --reduced --steps 20

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without
a GPU otherwise.
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-period", type=float, default=10.0)
    ap.add_argument("--ckpt-dir", default="repro_ckpt",
                    help="checkpoint directory (LocalFSStore root)")
    ap.add_argument("--codec", default="raw",
                    choices=["raw", "zlib", "int8", "int8+zlib"])
    ap.add_argument("--managed", action="store_true",
                    help="run under a CACS service instance")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke-test config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()

    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.train.trainer import TrainerApp

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)

    if args.managed:
        from repro_torch.ckpt import LocalFSStore
        from repro_torch.clusters import LocalBackend
        from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                      CoordState)
        svc = CACSService({"local": LocalBackend(n_hosts=1)},
                          {"default": LocalFSStore(args.ckpt_dir)})
        asr = ASR(name=f"train-{cfg.name}", n_vms=1, backend="local",
                  app_factory=lambda: TrainerApp(
                      cfg, global_batch=args.batch, seq_len=args.seq,
                      n_steps=args.steps, device=device),
                  policy=CheckpointPolicy(period_s=args.ckpt_period,
                                          codec=args.codec, keep_last=3))
        try:
            cid = svc.submit(asr)
            svc.wait_for_state(cid, CoordState.RUNNING, timeout=600)
            print(f"coordinator {cid} RUNNING on {device}")
            coord = svc.db.get(cid)
            while coord.app.current_step < max(1, args.steps // 2):
                time.sleep(0.2)
            step = svc.trigger_checkpoint(cid)
            info = svc.get_checkpoint(cid, step)
            print(f"checkpoint {step}: {info['bytes']:,} bytes, codec "
                  f"{info['codec']}")
            svc.restart_from(cid, step)
            print(f"restarted from checkpoint {step} (restarts "
                  f"{coord.app.restarts})")
            while not coord.app.is_done():
                time.sleep(1.0)
                print(f"step={coord.app.current_step} "
                      f"loss={coord.app.last_loss:.4f} "
                      f"ckpts={svc.list_checkpoints(cid)}")
            print(f"done: step={coord.app.current_step} "
                  f"loss={coord.app.last_loss:.4f} "
                  f"ckpts={svc.list_checkpoints(cid)}")
        finally:
            svc.shutdown()
        return

    # raw loop
    from repro_torch.ckpt import (AsyncCheckpointer, LocalFSStore,
                                  latest_step, list_steps, restore)
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    model = build_model(cfg)
    opt = AdamWConfig(total_steps=args.steps)
    step_fn = make_train_step(model, opt)
    store = LocalFSStore(args.ckpt_dir)
    pipeline = TokenPipeline(cfg, args.batch, args.seq)
    prefix = f"raw/{cfg.name}"
    ck = AsyncCheckpointer(store, prefix, codec=args.codec)

    if args.resume and latest_step(store, prefix) is not None:
        snap, man = restore(store, prefix, device=device)
        state = snap["state"]
        pipeline.load_state_dict(snap["data"])
        print(f"resumed from step {man.step}")
    else:
        state = init_state(model, 0, device)

    last_ckpt = time.monotonic()
    while int(state["step"]) < args.steps:
        state, metrics = step_fn(state, pipeline.next(device))
        s = int(state["step"])
        if s % 10 == 0:
            print(f"step={s} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if time.monotonic() - last_ckpt > args.ckpt_period:
            ck.save(s, {"state": state, "data": pipeline.state_dict()})
            last_ckpt = time.monotonic()
    ck.save(int(state["step"]),
            {"state": state, "data": pipeline.state_dict()})
    ck.close()
    print(f"done: checkpoints {list_steps(store, prefix)}")


if __name__ == "__main__":
    main()
