"""Hand-written CUDA kernels (+ plain-torch oracles) of the port.

  qsnap — blockwise int8 quantization of checkpoint images (swap-out
          encode on the card; format-compatible with
          repro_torch.ckpt.compression)

The attention kernels of the reference (flash_attention,
decode_attention) are not ported yet. Kernels build with ``nvcc`` at
first use (``kernels.build``); importing this package builds nothing.
"""
from repro_torch.kernels import qsnap, ref

__all__ = ["qsnap", "ref"]
