"""Serving launcher: batched greedy generation on the card, optionally
CACS-managed (a suspended serving job resumes mid-generation from its
KV-cache image). Port of ``repro/launch/serve.py``:

    python -m repro_torch.launch.serve --arch repro-100m --batch 8 \\
        --prompt-len 512 --tokens 128 [--managed]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without
a GPU otherwise.
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--managed", action="store_true",
                    help="run under a CACS service instance")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)

    if args.managed:
        from repro_torch.ckpt import InMemoryStore
        from repro_torch.clusters import LocalBackend
        from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                      CoordState)
        from repro_torch.serve.engine import ServeApp
        svc = CACSService({"local": LocalBackend(1)},
                          {"default": InMemoryStore()})
        asr = ASR(name=f"serve-{cfg.name}", n_vms=1, backend="local",
                  app_factory=lambda: ServeApp(
                      cfg, batch=args.batch, prompt_len=args.prompt_len,
                      n_tokens=args.tokens,
                      cache_len=args.prompt_len + args.tokens,
                      device=device),
                  policy=CheckpointPolicy(period_s=1.0, keep_last=2))
        try:
            cid = svc.submit(asr)
            svc.wait_for_state(cid, CoordState.RUNNING, timeout=600)
            coord = svc.db.get(cid)
            while not coord.app.is_done():
                time.sleep(1.0)
                print(f"generated {coord.app.generated}/{args.tokens}")
            print("tokens:",
                  coord.app.checkpoint_state()["tokens_out"][:, :16])
        finally:
            svc.shutdown()
        return

    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    engine = Engine(model, params, cache_len=args.prompt_len + args.tokens)
    rng = np.random.Generator(np.random.PCG64(0))
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.monotonic()
    out = engine.generate({"tokens": torch.from_numpy(prompt).to(device)},
                          args.tokens)
    out = out.cpu().numpy()              # waits for the last step
    dt = time.monotonic() - t0
    print(f"generated {out.shape} on {device} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print(out[:, :16])


if __name__ == "__main__":
    main()
