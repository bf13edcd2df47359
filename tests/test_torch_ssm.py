"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, from the same (JAX) init and numpy inputs.

All in f32 on the CPU. The port's in-chunk scan doubles over the chunk
axis where the reference runs ``lax.associative_scan``: the two combine
in different orders, so values agree within rtol=atol=1e-5 (the block's
output, its state ``h`` and conv window), not bit for bit; the conv,
which sums its taps in the reference's order, within 1e-6. Decode steps
from a prefilled state stay within 1e-5 of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.tree import leaves_with_path

JCFG = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                           dtype="float32")
TCFG = dataclasses.replace(treduced(tget_config("jamba-v0.1-52b")),
                           dtype="float32")
JSPEC = JS.MambaSpec(JCFG.d_model, JCFG.ssm, JCFG.norm_eps)
TSPEC = TS.MambaSpec(TCFG.d_model, TCFG.ssm, TCFG.norm_eps)
FWD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    b = JL.ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    JS.mamba_init(b, JSPEC)
    jp = b.params
    # dt_bias and A_log start at zero: give them values, so the test sees
    # their place in the formulas
    rng = np.random.default_rng(7)
    for name in ("dt_bias", "A_log", "conv_b"):
        jp[name] = jnp.asarray(
            0.5 * rng.standard_normal(jp[name].shape).astype(np.float32))
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def _x(B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, TCFG.d_model)).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_init_names_shapes_and_dims_match():
    jb = JL.ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    JS.mamba_init(jb, JSPEC)
    tb = TL.ParamBuilder(torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    TS.mamba_init(tb, TSPEC)
    assert [(p, tuple(t.shape)) for p, t in leaves_with_path(tb.params)] == \
        [(tuple(k.key for k in p), tuple(a.shape)) for p, a in
         jax.tree_util.tree_flatten_with_path(jb.params)[0]]
    assert tb.dims == jb.dims
    assert (TSPEC.d_inner, TSPEC.dt_rank) == (JSPEC.d_inner, JSPEC.dt_rank)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches(params, carried):
    jp, tp = params
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, TSPEC.d_inner)).astype(np.float32)
    state = rng.standard_normal((2, TCFG.ssm.d_conv - 1, TSPEC.d_inner)
                                ).astype(np.float32) if carried else None
    jy, js = JS._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             None if state is None else jnp.asarray(state))
    ty, ts = TS._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
                             None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(_np(ts), x[:, -(TCFG.ssm.d_conv - 1):])


@pytest.mark.parametrize("S", [16, 512])
def test_mamba_forward_matches(params, S):
    """S = 512 runs two chunks of 256: the state carried between them."""
    jp, tp = params
    x = _x(2, S)
    jy, jc = jax.jit(lambda p, x: JS._mamba_forward(p, JSPEC, x))(
        jp, jnp.asarray(x))
    ty, tc = TS._mamba_forward(tp, TSPEC, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), _np(jy), **FWD)
    assert sorted(tc) == sorted(jc)
    for k in tc:
        assert tc[k].dtype == torch.float32 and tc[k].shape == jc[k].shape
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **FWD)


def test_mamba_forward_grads_match(params):
    jp, tp = params
    x, dy = _x(2, 16, 3), _x(2, 16, 4)
    _, vjp = jax.vjp(lambda p, x: JS.mamba_apply(p, JSPEC, x), jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: t.clone().requires_grad_() for k, t in tp.items()}
    out = TS.mamba_apply(leaves, TSPEC, tx)
    grads = torch.autograd.grad(out, [tx, *leaves.values()],
                                torch.from_numpy(dy))
    np.testing.assert_allclose(_np(grads[0]), _np(jgx), rtol=1e-4, atol=1e-4)
    for k, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(_np(g), _np(jgp[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_mamba_decode_steps_match(params):
    """Prefill 16 tokens, then 4 one-token steps; the port writes its cache
    in place and returns the same tensors."""
    jp, tp = params
    x = _x(2, 20, 5)
    _, jc = JS.mamba_prefill(jp, JSPEC, jnp.asarray(x[:, :16]))
    _, tc = TS.mamba_prefill(tp, TSPEC, torch.from_numpy(x[:, :16]))
    cache = TS.mamba_cache_init(TSPEC, 2, torch.float32, "cpu")
    assert {k: (t.dtype, t.shape) for k, t in cache.items()} == {
        k: (torch.float32, tuple(t.shape)) for k, t in
        JS.mamba_cache_init(JSPEC, 2, jnp.float32).items()}
    for k in cache:
        cache[k].copy_(tc[k])
    held = dict(cache)
    for i in range(16, 20):
        jy, jc = JS.mamba_decode(jp, JSPEC, jnp.asarray(x[:, i:i + 1]), jc)
        ty, out = TS.mamba_decode(tp, TSPEC, torch.from_numpy(x[:, i:i + 1]),
                                  cache)
        assert all(out[k] is held[k] for k in held)
        np.testing.assert_allclose(_np(ty), _np(jy), **FWD)
        for k in cache:
            np.testing.assert_allclose(_np(cache[k]), _np(jc[k]), **FWD)


def test_a_prompt_not_divisible_into_chunks_fails_in_both(params):
    jp, tp = params
    x = _x(1, 513)
    with pytest.raises(AssertionError, match="not divisible into chunks"):
        JS._mamba_forward(jp, JSPEC, jnp.asarray(x))
    with pytest.raises(AssertionError, match="not divisible into chunks"):
        TS._mamba_forward(tp, TSPEC, torch.from_numpy(x))


@pytest.mark.parametrize("Q", [1, 5, 8, 256])
def test_doubling_scan_equals_the_step_by_step_recurrence(Q):
    """h_t = a_t * h_{t-1} + b_t from h = 0, in f64: the doubling scan's
    (a_cum, b_cum) are the running products and states."""
    g = torch.Generator().manual_seed(Q)
    a = torch.rand((2, Q, 3, 4), generator=g, dtype=torch.float64)
    b = torch.randn((2, Q, 3, 4), generator=g, dtype=torch.float64)
    a_cum, b_cum = TS._chunk_scan(a, b)
    h, p = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(Q):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        torch.testing.assert_close(b_cum[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(a_cum[:, t], p, rtol=1e-12, atol=1e-12)
