"""Deterministic, checkpointable synthetic data pipeline.

The iterator state is part of every checkpoint ({"seed", "step"}), so a
restarted/migrated job consumes *exactly* the byte stream it would have seen
without the failure — batch k is a pure function of (seed, k). On restore
under a different data-parallel degree (elastic migration), the same global
batch is simply re-sharded — determinism is topology-independent.

Port of ``repro/data/pipeline.py``: batches are the same numpy arrays, bit
for bit; ``next`` places them on a torch device instead of a sharding tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


class TokenPipeline:
    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, dtype=np.float32):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0
        self.dtype = dtype

    # ---- checkpointable state ------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "step": self.step,
                "global_batch": self.global_batch, "seq_len": self.seq_len}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    # ---- batches ---------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.PCG64([self.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) — the determinism contract."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = self.global_batch, self.seq_len
        V = cfg.vocab_size

        def toks(b, s):
            # learnable structure: per-row arithmetic progressions with a
            # small random stride — next-token entropy << log(V), so test
            # runs can verify the loss actually falls
            start = rng.integers(0, V, size=(b, 1), dtype=np.int64)
            stride = rng.integers(1, 8, size=(b, 1), dtype=np.int64)
            seq = (start + stride * np.arange(s, dtype=np.int64)) % V
            return seq.astype(np.int32)

        if cfg.family == "encdec":
            tokens = toks(B, S)
            targets = np.roll(tokens, -1, axis=1)
            targets[:, -1] = -1
            frames = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(self.dtype) * 0.02
            return {"frames": frames, "tokens": tokens, "targets": targets}
        if cfg.frontend is not None:
            F = cfg.frontend_len
            tokens = toks(B, S - F)
            targets = np.full((B, S), -1, np.int32)
            targets[:, F:-1] = tokens[:, 1:]
            patches = rng.standard_normal(
                (B, F, cfg.d_model)).astype(self.dtype) * 0.02
            return {"patch_embeds": patches, "tokens": tokens,
                    "targets": targets}
        tokens = toks(B, S)
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = -1
        return {"tokens": tokens, "targets": targets}

    def next(self, device: Optional[Any] = None) -> Dict[str, Any]:
        batch = self.batch_at(self.step)
        self.step += 1
        if device is not None:
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
        return batch
