"""The decode kernel's log-sum-exp, on the CPU route: what the data ranks
of a context-parallel decode merge.

``ref.decode_attention_lse_ref`` against a ``torch.logsumexp`` formula
and, for its output, against the JAX package's ``kernels/ref.py`` oracle
on the same numpy inputs; ``pos = -1`` (an empty slice) gives zeros and
-inf with no NaN on every route (``kernels.ops.decode_attention(...,
return_lse=True)``, the dispatcher, the ``meta`` route, which records no
launch for it and ``4 B H`` more bytes for the ``lse`` it writes). The
kernel's own ``lse`` is held to this oracle on the card
(``tests/test_torch_cuda.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as DA

# (B, T, H, Hkv, hd, pos)
CASES = [(2, 40, 4, 2, 16, 0), (1, 64, 8, 2, 32, 63), (2, 100, 6, 3, 16, 37),
         (1, 300, 4, 1, 64, 255)]


def _inputs(B, T, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, hd)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_is_the_logsumexp_of_the_visible_scores(case):
    B, T, H, Hkv, hd, pos = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, T, H, Hkv, hd))
    out, lse = ref.decode_attention_lse_ref(q, k, v, pos)
    kk = k.repeat_interleave(H // Hkv, dim=1)[:, :, :pos + 1]
    s = torch.einsum("bhd,bhtd->bht", q, kk) / math.sqrt(hd)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.allclose(lse, torch.logsumexp(s, dim=-1), atol=1e-5)
    assert torch.allclose(out, ref.decode_attention_ref(q, k, v, pos),
                          atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_ref_output_matches_the_jax_oracle(case):
    B, T, H, Hkv, hd, pos = case
    arrs = _inputs(B, T, H, Hkv, hd, seed=1)
    want = np.asarray(jref.decode_attention_ref(
        *(jnp.asarray(a) for a in arrs), pos))
    out, _ = ref.decode_attention_lse_ref(
        *(torch.from_numpy(a) for a in arrs), pos)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("route", ["ref", "ops", "dispatch", "ops_ref"])
def test_empty_slice_gives_zeros_and_minus_inf(route):
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 16, 4, 2, 8))
    if route == "ref":
        out, lse = ref.decode_attention_lse_ref(q, k, v, -1)
    elif route == "dispatch":
        out, lse = DA.decode_attention_bhd(q, k, v, -1, return_lse=True)
    else:
        out, lse = ops.decode_attention(
            q[:, None], k.transpose(1, 2), v.transpose(1, 2), -1,
            impl="ref" if route == "ops_ref" else None, return_lse=True)
        out, lse = out[:, 0], lse[:, 0]
    assert out.shape == q.shape and lse.shape == (2, 4)
    assert (out == 0).all() and not torch.isnan(lse).any()
    assert torch.isinf(lse).all() and (lse < 0).all()


def test_ops_return_lse_matches_the_oracle():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 50, 6, 2, 16, seed=2))
    plain = ops.decode_attention(q[:, None], k.transpose(1, 2),
                                 v.transpose(1, 2), 20)
    out, lse = ops.decode_attention(q[:, None], k.transpose(1, 2),
                                    v.transpose(1, 2), 20, return_lse=True)
    want_o, want_l = ref.decode_attention_lse_ref(q, k, v, 20)
    assert torch.allclose(out, plain, atol=1e-6)
    assert out.shape == (2, 1, 6, 16) and lse.shape == (2, 1, 6)
    assert torch.allclose(out[:, 0], want_o, atol=1e-6)
    assert torch.equal(lse[:, 0], want_l)


def test_meta_route_records_the_lse_bytes_and_no_empty_launch():
    B, T, H, Hkv, hd = 1, 128, 8, 2, 64
    q = torch.empty(B, H, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Hkv, T, hd, dtype=torch.bfloat16, device="meta")
    build.META_CALLS.clear()
    DA.decode_attention_bhd(q, k, k, 99)
    plain = list(build.META_CALLS["decode_attention"])
    build.META_CALLS.clear()
    out, lse = DA.decode_attention_bhd(q, k, k, 99, return_lse=True)
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    calls, flops, n_bytes = build.META_CALLS["decode_attention"]
    assert (calls, flops) == tuple(plain[:2])
    assert n_bytes == plain[2] + 4 * B * H
    build.META_CALLS.clear()
    DA.decode_attention_bhd(q, k, k, -1, return_lse=True)
    assert "decode_attention" not in build.META_CALLS
