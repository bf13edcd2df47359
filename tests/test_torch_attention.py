"""The port's attention wrappers against the JAX package's Pallas kernels.

The same inputs, made with numpy from a seed, go through the JAX
``repro.kernels.ops`` functions with the Pallas kernel in interpret mode
and through the port's ``repro_torch.kernels.ops`` on the CPU, where each
dispatcher takes its kernel's plain version. Case grids and tolerances
are those of ``tests/test_kernels.py``: 2e-5 in f32 (the two sum in
different orders), 2e-2 in bf16 (outputs rounded to bf16). The CUDA
kernels themselves are held against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from test_kernels import DECODE_CASES, FLASH_CASES

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, S, H, Hkv, hd, dtype, T=None, seed=7):
    """numpy f32 draws, rounded to ``dtype`` the same way on both sides."""
    rng = np.random.Generator(np.random.PCG64(seed))
    T = T or S
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(out_t, out_j, dtype):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_pallas_kernel(case, dtype):
    B, S, H, Hkv, hd, window, blk = case
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, Hkv, hd, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                impl="pallas", interpret=True,
                                block_q=blk, block_k=blk)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.shape == (B, S, H, hd) and got.dtype == q.dtype
    _close(got, want, dtype)
    _close(ops.flash_attention(q, k, v, causal=True, window=window,
                               impl="ref"), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_pallas_kernel(case, dtype):
    B, T, H, Hkv, hd, pos, blk = case
    (jq, jk, jv), (q, k, v) = _qkv(B, 1, H, Hkv, hd, dtype, T=T)
    want = jops.decode_attention(jq, jk, jv, jnp.int32(pos), impl="pallas",
                                 interpret=True, block_k=blk)
    got = ops.decode_attention(q, k, v, pos)
    assert got.shape == (B, 1, H, hd) and got.dtype == q.dtype
    _close(got, want, dtype)
    _close(ops.decode_attention(q, k, v, pos, impl="ref"), want, dtype)


def test_decode_ignores_stale_cache_slots():
    """Slots beyond pos hold garbage after restore — must not leak in, in
    the port as in the JAX kernel."""
    B, T, H, Hkv, hd, pos = 1, 256, 4, 2, 64, 99
    (jq, jk, jv), (q, k, v) = _qkv(B, 1, H, Hkv, hd, "float32", T=T)
    pk, pv = k.clone(), v.clone()
    pk[:, pos + 1:], pv[:, pos + 1:] = 1e4, -1e4
    clean = ops.decode_attention(q, k, v, pos)
    poisoned = ops.decode_attention(q, pk, pv, pos)
    np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), atol=1e-6)
    want = jops.decode_attention(jq, jnp.asarray(pk.numpy()),
                                 jnp.asarray(pv.numpy()), jnp.int32(pos),
                                 impl="pallas", interpret=True, block_k=64)
    _close(poisoned, want, "float32")


def test_unknown_impl_is_refused():
    _, (q, k, v) = _qkv(1, 8, 2, 1, 32, "float32")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q[:, :1], k, v, 3, impl="cuda")


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_kernel_wrappers_take_only_cuda_tensors(kernel):
    """The CUDA entry points raise on a CPU tensor (the dispatchers route
    those to the plain versions) and on what the kernels do not take."""
    _, (q, k, v) = _qkv(1, 8, 4, 2, 64, "float32")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    call = {"flash": lambda q_: FA.flash_attention_bhsd_cuda(q_, kt, vt),
            "decode": lambda q_: DA.decode_attention_bhd_cuda(
                q_[:, :, 0], kt, vt, 3)}[kernel]
    with pytest.raises(ValueError, match="CUDA device"):
        call(qt)
    with pytest.raises(TypeError, match="dtypes"):
        FA.check_operands("x", qt.half(), kt, vt)
    _, (q48, k48, v48) = _qkv(1, 8, 4, 2, 48, "float32")
    with pytest.raises(ValueError, match="head dim 48"):
        FA.check_operands("x", *(t.transpose(1, 2)
                                 for t in (q48, k48, v48)))
    with pytest.raises(ValueError, match="q-heads"):
        FA.check_operands("x", qt[:, :3], kt, vt)
