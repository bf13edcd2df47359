"""Hand-written CUDA kernels (+ plain-torch oracles) of the port.

  qsnap            — blockwise int8 quantization of checkpoint images
                     (swap-out encode on the card; format-compatible with
                     repro_torch.ckpt.compression)
  flash_attention  — blocked GQA attention forward (serving prefill, and
                     with its log-sum-exp the train step's) and its
                     backward (the train step)
  decode_attention — one-token GQA attention over the KV cache (decode)

``ops`` wraps the two attention kernels in the model's ``[B,S,H,hd]``
layout (the flash pair as an autograd function for training); ``ref``
holds the plain oracles. Kernels build with ``nvcc`` at
first use (``kernels.build``); importing this package builds nothing.
"""
from repro_torch.kernels import (decode_attention, flash_attention, ops,
                                 qsnap, ref)

__all__ = ["decode_attention", "flash_attention", "ops", "qsnap", "ref"]
