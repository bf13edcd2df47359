"""Hand a JAX-package state to the port, and back, as numpy arrays.

``jax.random`` cannot be replayed in torch, so tests that hold the two
packages against each other start both from the JAX init: the caller
turns its params or train state into numpy (``jax.device_get``; bf16
arrays keep their ``bfloat16`` dtype, recognised by name and moved as
their raw 16-bit words), and these functions build the port's tensors
with the same names, shapes and key order. Nothing here imports JAX or
``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.ckpt.layout import host_array, to_tensor
from repro_torch.device import resolve_device
from repro_torch.tree import map_dicts


def _tensor(a: Any, device: Any) -> Any:
    if not isinstance(a, np.ndarray):
        return a                      # python scalars pass through
    return to_tensor(a.view(np.int16) if str(a.dtype) == "bfloat16" else a,
                     str(a.dtype), device)


def params_from_jax(np_tree: Any, device: Any = None) -> Any:
    """Nested dict of numpy arrays (JAX param layout) -> tensors on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    return map_dicts(lambda a: _tensor(np.asarray(a), device), np_tree)


def state_from_jax(np_state: Any, device: Any = None) -> Any:
    """A JAX train state {params, opt_state: {m, v, count}, step} (or any
    nested dict) as numpy -> the port's tensors on ``device`` (``cuda``
    unless ``"cpu"`` is asked for); non-array leaves pass through."""
    device = resolve_device(device)
    return map_dicts(lambda a: _tensor(a, device), np_state)


def params_to_numpy(tree: Any) -> Any:
    """Tensors -> numpy arrays (bf16 as its int16 words); other leaves
    pass through."""
    return map_dicts(lambda t: host_array(t)
                     if isinstance(t, torch.Tensor) else t, tree)
