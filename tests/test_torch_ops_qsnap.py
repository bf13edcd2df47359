"""The qsnap half of ``kernels.ops`` against the JAX package's:
``qsnap_compress`` pads any shape to ``QSNAP_BLOCK`` and returns the
reference's ``(codes, scales, n_orig)`` bit for bit (``impl="ref"`` on
both sides, and the port's dispatcher, which takes the plain version for
a CPU tensor), on ragged sizes and a 3-D tensor, f32 and bf16;
``qsnap_decompress`` inverts it to the shape and dtype asked for, equal
to the reference's. The CUDA route is checked on the card by
``chip_smoke.py`` (one ragged round trip)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

SHAPES = [(1,), (255,), (257,), (3 * 256 + 1,), (3, 5, 37)]


def _values(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    x.reshape(-1)[:1] = 0.0
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(jx, np.float32), tx.float().numpy())
        return jx, tx
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_qsnap_compress_matches_the_reference_bit_for_bit(shape, dtype):
    jx, tx = _values(shape, dtype)
    jc, js, jn = jops.qsnap_compress(jx, impl="ref")
    for impl in ("ref", None):
        tc, ts, tn = ops.qsnap_compress(tx, impl=impl)
        assert tn == jn == int(np.prod(shape))
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        assert tc.numel() % ops.QSNAP_BLOCK == 0
        assert np.array_equal(tc.numpy(), np.asarray(jc)), impl
        assert ts.numpy().tobytes() == np.asarray(js).tobytes(), impl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_qsnap_decompress_matches_the_reference(shape, dtype):
    jx, tx = _values(shape, dtype)
    jc, js, jn = jops.qsnap_compress(jx, impl="ref")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jops.qsnap_decompress(jc, js, jn, shape, jdt,
                                            impl="ref"), np.float32)
    tdt = getattr(torch, dtype)
    tc, ts, tn = ops.qsnap_compress(tx)
    for impl in ("ref", None):
        back = ops.qsnap_decompress(tc, ts, tn, shape, tdt, impl=impl)
        assert tuple(back.shape) == shape and back.dtype == tdt
        assert back.float().numpy().tobytes() == want.tobytes(), impl
