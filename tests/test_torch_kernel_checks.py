"""What the attention wrappers check before a launch, on the CPU.

The redesigned kernels copy q, k and v in 16-byte pieces, so
``flash_attention.check_aligned`` refuses a view whose base is not
16-byte aligned or whose outer strides are not multiples of 16 bytes.
The views the main path hands the kernels (``kernels.ops``'s
``[B,S,H,hd]`` -> ``[B,H,S,hd]`` transposes, decode's ``q[:, 0]``) must
pass, at every head dim the kernels take.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

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
