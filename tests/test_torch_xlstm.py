"""The port's xLSTM blocks against the JAX package's, from the same init.

The mLSTM and sLSTM blocks of reduced ``xlstm-125m`` (d_model 128, 4
heads, mLSTM head dim 64) are built with the JAX package's
``ParamBuilder`` and handed to the port through ``repro_torch.convert``;
inputs come from a numpy seed. All in f32 on the CPU:
  * the forward at S = 16 (one chunk), 256 (two chunks of 128) and 300
    (two chunks of 150: the reference splits S into ``S // 128`` equal
    chunks) within rtol = atol = 1e-5 (XLA and torch sum the chunk
    products in different orders);
  * the prefill states (mLSTM ``C``, ``n``, ``conv``; sLSTM ``c``, ``n``,
    ``h``, ``m``) within the same tolerance;
  * three decode steps from those states, outputs and states, within
    rtol = atol = 1e-5;
  * a sequence whose length the chunking cannot split is refused, as the
    reference asserts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import xlstm as JX
from repro_torch.convert import params_from_jax
from repro_torch.models import xlstm as TX

CFG = reduced(get_config("xlstm-125m"))
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = {
    "mlstm": (JX.MLSTMSpec(CFG.d_model, CFG.n_heads, CFG.xlstm, CFG.norm_eps),
              JX.mlstm_init, JX.mlstm_apply, JX.mlstm_prefill,
              JX.mlstm_decode, TX.mlstm_apply, TX.mlstm_prefill,
              TX.mlstm_decode),
    "slstm": (JX.SLSTMSpec(CFG.d_model, CFG.n_heads, CFG.norm_eps),
              JX.slstm_init, JX.slstm_apply, JX.slstm_prefill,
              JX.slstm_decode, TX.slstm_apply, TX.slstm_prefill,
              TX.slstm_decode),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tspec(kind, jspec):
    """The port's spec of the same block (the same fields)."""
    cls = TX.MLSTMSpec if kind == "mlstm" else TX.SLSTMSpec
    return cls(**{f.name: getattr(jspec, f.name)
                  for f in dataclasses.fields(jspec)})


@pytest.fixture(scope="module", params=sorted(KINDS))
def block(request):
    kind = request.param
    jspec, jinit = KINDS[kind][:2]
    b = JL.ParamBuilder(jax.random.PRNGKey(7), jnp.float32)
    jinit(b, jspec)
    jp = b.params
    return kind, jspec, _tspec(kind, jspec), jp, params_from_jax(
        jax.device_get(jp), "cpu")


def _x(S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_states(tstate, jstate):
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        if k != "conv":
            assert tstate[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(tstate[k]), _np(jstate[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("S", [16, 256, 300])
def test_forward_matches_jax(block, S):
    kind, jspec, tspec, jp, tp = block
    japply, tapply = KINDS[kind][2], KINDS[kind][5]
    x = _x(S, jspec.d_model, S)
    np.testing.assert_allclose(_np(tapply(tp, tspec, torch.from_numpy(x))),
                               _np(japply(jp, jspec, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("S", [16, 256, 300])
def test_prefill_states_then_three_decode_steps_match_jax(block, S):
    kind, jspec, tspec, jp, tp = block
    _, _, _, jprefill, jdecode, _, tprefill, tdecode = KINDS[kind]
    x = _x(S, jspec.d_model, S + 1)
    jy, jstate = jprefill(jp, jspec, jnp.asarray(x))
    ty, tstate = tprefill(tp, tspec, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _close_states(tstate, jstate)
    for i in range(3):
        xt = _x(1, jspec.d_model, 100 + i)
        jy, jstate = jdecode(jp, jspec, jnp.asarray(xt), jstate)
        ty, same = tdecode(tp, tspec, torch.from_numpy(xt), tstate)
        assert same is tstate                 # written in place
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"step {i}",
                                   **TOL)
        _close_states(tstate, jstate)


def test_mlstm_refuses_a_sequence_the_chunks_cannot_split():
    spec = _tspec("mlstm", KINDS["mlstm"][0])
    b = JL.ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    JX.mlstm_init(b, KINDS["mlstm"][0])
    tp = params_from_jax(jax.device_get(b.params), "cpu")
    with pytest.raises(AssertionError, match="not divisible"):
        TX.mlstm_apply(tp, spec, torch.zeros(1, 257, spec.d_model))


def test_decode_cache_init_matches_jax(block):
    kind, jspec, tspec, _, _ = block
    jinit = {"mlstm": JX.mlstm_cache_init, "slstm": JX.slstm_cache_init}
    tinit = {"mlstm": TX.mlstm_cache_init, "slstm": TX.slstm_cache_init}
    jc = jinit[kind](jspec, 3, jnp.bfloat16)
    tc = tinit[kind](tspec, 3, torch.bfloat16, "cpu")
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in tc.items()} \
        == {k: (tuple(t.shape), str(t.dtype)) for k, t in jc.items()}
