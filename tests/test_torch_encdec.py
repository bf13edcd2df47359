"""The port's encoder-decoder and vision-frontend pieces against the JAX
package's, from the same init (reduced ``seamless-m4t-medium`` and
``internvl2-2b``, f32, on the CPU, inputs from a numpy seed):
  * cross-attention of a prompt over an encoder memory of another length
    through the flash kernel's plain version (non-causal, S != T), and one
    decode step over it through the decode kernel's plain version at
    ``pos = T_enc - 1``, equal the reference's ``attention_ref`` paths
    within rtol = atol = 1e-5;
  * the encoder in serving (its attention through the flash kernel's
    plain version) equals the reference's encoder forward, and the port's
    own training forward, within 1e-5;
  * prefill keeps the reference's cross-attention memory ``mk``/``mv``
    (within 1e-5) and a vlm's prompt is its patch embeddings then its
    tokens, positions over both;
  * ``Engine.generate`` decodes a vlm from position ``frontend_len +
    prompt`` on, and an enc-dec model from the prompt's end (its frames
    are the encoder's), as the reference's engine does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Engine

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(treduced(tget_config(arch)), dtype="float32")
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jparams, params_from_jax(jax.device_get(jparams), "cpu")


@pytest.fixture(scope="module")
def seamless():
    return _models("seamless-m4t-medium")


def _rand(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _first(tree):
    """Group 0 of a stacked param tree."""
    return {k: (_first(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


@pytest.mark.parametrize("S,T", [(5, 8), (12, 8), (1, 13)])
def test_cross_attention_prefill_and_decode_match_jax(seamless, S, T):
    jm, tm, jparams, tparams = seamless
    (jblk,) = [b for b in jm.blocks if b.kind == "cross_attn"]
    (tblk,) = [b for b in tm.blocks if b.kind == "cross_attn"]
    jp, tp = (_first(p["stack"])[jblk.name] for p in (jparams, tparams))
    x, enc = _rand(B, S, tm.cfg.d_model, seed=S), \
        _rand(B, T, tm.cfg.d_model, seed=T)
    jmem = JL.cross_attn_memory(jp, jblk.spec, jnp.asarray(enc))
    tmem = TL.cross_attn_memory(tp, tblk.spec, torch.from_numpy(enc))
    for j, t in zip(jmem, tmem):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)
    want = JL.attn_apply(jp, jblk.spec, jnp.asarray(x),
                         positions=jnp.arange(S), memory=jmem)
    np.testing.assert_allclose(
        _np(TL.cross_attn_prefill(tp, tblk.spec, torch.from_numpy(x), tmem)),
        _np(want), **TOL)
    np.testing.assert_allclose(
        _np(TL.attn_apply(tp, tblk.spec, torch.from_numpy(x),
                          positions=torch.arange(S), memory=tmem)),
        _np(want), **TOL)
    xt = x[:, :1]
    np.testing.assert_allclose(
        _np(TL.cross_attn_decode(tp, tblk.spec, torch.from_numpy(xt), tmem)),
        _np(JL.cross_attn_decode(jp, jblk.spec, jnp.asarray(xt), jmem)),
        **TOL)


def test_encoder_in_serving_matches_jax_and_training(seamless):
    jm, tm, jparams, tparams = seamless
    frames = _rand(B, tm.cfg.frontend_len, tm.cfg.d_model, seed=3) * 0.5
    want = jm._encoder_forward(jparams, jnp.asarray(frames), remat=False)
    served = tm._encoder_forward(tparams, torch.from_numpy(frames),
                                 serve=True)
    trained = tm._encoder_forward(tparams, torch.from_numpy(frames),
                                  remat=False)
    np.testing.assert_allclose(_np(served), _np(want), **TOL)
    np.testing.assert_allclose(_np(trained), _np(want), **TOL)
    # the serving encoder is attention and MLP blocks only
    with pytest.raises(ValueError, match="encoder block"):
        TT.stack_encode(tparams["stack"], tm.blocks,
                        torch.from_numpy(frames), torch.arange(8))


def test_prefill_keeps_the_reference_cross_attention_memory(seamless):
    jm, tm, jparams, tparams = seamless
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tm.cfg.vocab_size, (B, 6)).astype(np.int32)
    frames = _rand(B, tm.cfg.frontend_len, tm.cfg.d_model, seed=4) * 0.02
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                           "frames": jnp.asarray(frames)},
                                 cache_len=10)
    logits, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                         "frames": torch.from_numpy(frames)},
                               cache_len=10)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert sorted(cache["l0_xattn"]) == ["mk", "mv"]
    for kk in ("mk", "mv"):
        t, j = cache["l0_xattn"][kk], jcache["l0_xattn"][kk]
        assert tuple(t.shape) == tuple(j.shape) == (
            tm.n_groups, B, tm.cfg.frontend_len, tm.cfg.n_kv_heads,
            tm.cfg.head_dim)
        np.testing.assert_allclose(_np(t), _np(j), **TOL)


def test_vlm_prompt_is_patch_embeds_then_tokens():
    jm, tm, jparams, tparams = _models("internvl2-2b")
    F = tm.cfg.frontend_len
    tokens = np.arange(B * 5, dtype=np.int32).reshape(B, 5)
    pe = _rand(B, F, tm.cfg.d_model, seed=9)
    jx, jpos, jenc = jm._inputs(jparams, {"tokens": jnp.asarray(tokens),
                                          "patch_embeds": jnp.asarray(pe)})
    x, pos, enc, sp = tm._inputs(tparams,
                                 {"tokens": torch.from_numpy(tokens),
                                  "patch_embeds": torch.from_numpy(pe)})
    assert jenc is None and enc is None and not sp
    np.testing.assert_array_equal(_np(pos), np.arange(F + 5))
    np.testing.assert_array_equal(_np(pos), _np(jpos))
    np.testing.assert_allclose(_np(x), _np(jx), **TOL)
    np.testing.assert_array_equal(_np(x[:, :F]), pe)


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-medium"])
def test_generate_decodes_from_the_reference_positions(arch):
    """internvl2's decode steps write the slots from ``frontend_len +
    prompt`` on (the patch embeddings hold the first ones); seamless's
    from the prompt's end. Without the offset a vlm would write its KV
    into slots its prompt holds."""
    cfg = dataclasses.replace(treduced(tget_config(arch)), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    F = cfg.frontend_len if cfg.family == "vlm" else 0
    S, n = 6, 4
    engine = Engine(model, params, cache_len=F + S + n)
    seen = []
    real = engine.decode

    def decode(cache, token, pos):
        seen.append(pos)
        return real(cache, token, pos)
    engine.decode = decode
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    extra = "frames" if cfg.family == "encdec" else "patch_embeds"
    batch[extra] = torch.from_numpy(
        _rand(B, cfg.frontend_len, cfg.d_model, seed=1) * 0.02)
    assert engine.generate(batch, n).shape == (B, n)
    assert seen == [F + S + i for i in range(n - 1)]
