"""What the kernel wrappers check before a launch, on the CPU.

The redesigned attention kernels copy q, k and v in 16-byte pieces, so
``flash_attention.check_aligned`` refuses a view whose base is not
16-byte aligned or whose outer strides are not multiples of 16 bytes.
The views the main path hands the kernels (``kernels.ops``'s
``[B,S,H,hd]`` -> ``[B,H,S,hd]`` transposes, decode's ``q[:, 0]``) must
pass, at every head dim the kernels take.

The qsnap dequantize kernel loads codes and stores values in 16-byte
vectors, so ``qsnap.check_aligned`` refuses codes or an output whose
base is off 16 bytes, and scales off 4. What the restore path hands it
(the reader's uploads, fresh outputs, the quantize step's results) must
pass, at sizes on either side of the kernel's tile.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt.reader import _upload
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import qsnap

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_main_path_views_pass(dtype, hd):
    B, S, H, Hkv, T = 2, 37, 12, 4, 53
    q = torch.empty(B, S, H, hd, dtype=dtype)
    k = torch.empty(B, T, Hkv, hd, dtype=dtype)
    FA.check_aligned("x", q.transpose(1, 2), k.transpose(1, 2),
                     torch.empty_like(q.transpose(1, 2)))
    FA.check_aligned("x", q[:, 0], k.transpose(1, 2))     # decode


@pytest.mark.parametrize("dtype", DTYPES)
def test_base_off_16_bytes_is_refused(dtype):
    x = torch.empty(1, 4, 64, 72, dtype=dtype)[..., 1:65]
    with pytest.raises(ValueError, match="16-byte"):
        FA.check_aligned("x", x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_not_16_bytes_apart_are_refused(dtype):
    x = torch.empty(1, 4, 64, 66, dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        FA.check_aligned("x", x)
    y = torch.empty(1, 4 * 66, dtype=dtype).view(1, 4, 66)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        FA.check_aligned("x", y)                          # decode's q


# around the dequantize kernel's CTA tile (16,384 codes) and past a few
QSNAP_SIZES = [256, 4096, 16128, 16384, 16640, 3 * 16384 + 512]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", QSNAP_SIZES)
def test_dequantize_main_path_operands_pass(n, dtype):
    rng = np.random.default_rng(n)
    cpu = torch.device("cpu")
    codes = _upload(rng.integers(-127, 128, n, dtype=np.int8), torch.int8,
                    cpu)
    scales = _upload(rng.random(n // 256, dtype=np.float32), torch.float32,
                     cpu)
    qsnap.check_aligned("x", codes, scales, torch.empty(n, dtype=dtype))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    qc, qs = qsnap.qsnap_quantize_plain(x.to(dtype))
    qsnap.check_aligned("x", qc, qs, torch.empty(n, dtype=dtype))


def _off(n: int, dtype, nbytes: int) -> torch.Tensor:
    """n elements of a numpy ``dtype`` whose base is ``nbytes`` past a
    64-byte boundary (numpy allows any offset, torch views do not)."""
    size = np.dtype(dtype).itemsize
    buf = np.zeros(n * size + 128, dtype=np.uint8)
    start = (-buf.ctypes.data) % 64 + nbytes
    return torch.from_numpy(buf[start:start + n * size].view(dtype))


@pytest.mark.parametrize("operand,nbytes", [("codes", 1), ("codes", 8),
                                            ("out", 4), ("out", 8),
                                            ("scales", 2)])
def test_dequantize_unaligned_operands_are_refused(operand, nbytes):
    n = 512
    ops = {"codes": torch.zeros(n, dtype=torch.int8),
           "scales": torch.ones(n // 256),
           "out": torch.empty(n)}
    ops[operand] = _off(ops[operand].numel(), ops[operand].numpy().dtype,
                        nbytes)
    assert ops[operand].data_ptr() % 16 == nbytes
    with pytest.raises(ValueError, match="16-byte"):
        qsnap.check_aligned("x", ops["codes"], ops["scales"], ops["out"])
