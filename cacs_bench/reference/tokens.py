"""The training cell's token batches, worked out from (seed, step).

The rule the training job's data pipeline documents: each row is an
arithmetic progression modulo the vocabulary with a random start and a
stride of 1 to 7, drawn from PCG64([seed, step]); the targets are the
tokens shifted left by one, the last target -1 (ignored).
"""
from __future__ import annotations

import numpy as np


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int):
    rng = np.random.Generator(np.random.PCG64([seed, step]))
    start = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    stride = rng.integers(1, 8, size=(batch, 1), dtype=np.int64)
    tokens = ((start + stride * np.arange(seq, dtype=np.int64))
              % vocab).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    return tokens, targets


def prompt(seed: int, batch: int, prompt_len: int, vocab: int) -> np.ndarray:
    """The served job's prompt rows: uniform ids from PCG64(seed)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32)
