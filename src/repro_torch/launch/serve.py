"""Serving launcher: batched greedy generation on the card.

Port of the unmanaged path of ``repro/launch/serve.py``:

    python -m repro_torch.launch.serve --arch repro-100m --batch 8 \\
        --prompt-len 512 --tokens 128

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without
a GPU otherwise. The reference's ``--managed`` path (a CACS-hosted
``ServeApp`` under ``CACSService``) waits for the port of the control
plane and is not offered here.
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
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
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
