"""The port's dense model against the JAX package's, from the same init.

``jax.random`` cannot be replayed in torch, so the JAX init is handed to
the port through ``repro_torch.convert`` and the inputs are made with
numpy. All in f32 on the CPU, where XLA and torch still sum in different
orders: forward values agree within rtol=atol=1e-5, gradients within
1e-4, one AdamW step within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.tree import leaves_with_path, tree_leaves

CFG = dataclasses.replace(reduced(get_config("repro-100m")), dtype="float32")
TCFG = dataclasses.replace(treduced(tget_config("repro-100m")),
                           dtype="float32")
B, S = 2, 16
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jm, tm = JM.build_model(CFG), TM.build_model(TCFG)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    targets[0, -3:] = -1                          # masked positions
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "targets": torch.from_numpy(targets)}
    return jm, tm, jparams, tparams, jbatch, tbatch


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_param_tree_names_and_shapes_match(setup):
    jm, tm, jparams, tparams, _, _ = setup
    jl = [(tuple(k.key for k in path), tuple(x.shape)) for path, x in
          jax.tree_util.tree_flatten_with_path(jparams)[0]]
    ours = tm.init(torch.Generator().manual_seed(0), "cpu")
    for tree in (tparams, ours):
        assert [(p, tuple(x.shape)) for p, x in leaves_with_path(tree)] == jl
    assert all(x.dtype == torch.float32 for x in tree_leaves(ours))


def _logits_jax(jm, p, tokens):
    x = JL.embed_apply(p["embed"], tokens, jm.dtype)
    x, _ = JT.stack_forward(p["stack"], jm.blocks, x,
                            jnp.arange(tokens.shape[1]), remat=False)
    x = JL.rmsnorm(x, p["embed"]["final_norm"], CFG.norm_eps)
    return JL.unembed_apply(p["embed"], x, CFG.tie_embeddings)


def _logits_torch(tm, p, tokens):
    x = TL.embed_apply(p["embed"], tokens, tm.dtype)
    x, _ = TT.stack_forward(p["stack"], tm.blocks, x,
                            torch.arange(tokens.shape[1]), remat=False)
    x = TL.rmsnorm(x, p["embed"]["final_norm"], TCFG.norm_eps)
    return TL.unembed_apply(p["embed"], x, TCFG.tie_embeddings)


def test_logits_match(setup):
    jm, tm, jparams, tparams, jbatch, tbatch = setup
    np.testing.assert_allclose(
        _np(_logits_torch(tm, tparams, tbatch["tokens"])),
        _np(_logits_jax(jm, jparams, jbatch["tokens"])), **FWD)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches(setup, remat):
    jm, tm, jparams, tparams, jbatch, tbatch = setup
    jl, jaux = jm.loss(jparams, jbatch, remat=remat)
    tl, taux = tm.loss(tparams, tbatch, remat=remat)
    np.testing.assert_allclose(_np(tl), _np(jl), **FWD)
    np.testing.assert_allclose(_np(taux["ce"]), _np(jaux["ce"]), **FWD)


def _model_grads(setup):
    jm, tm, jparams, tparams, jbatch, tbatch = setup
    jg = jax.grad(lambda p: jm.loss(p, jbatch, remat=False)[0])(jparams)
    req = [t.requires_grad_() for t in tree_leaves(tparams)]
    tg = torch.autograd.grad(tm.loss(tparams, tbatch, remat=False)[0], req)
    for t in req:
        t.requires_grad_(False)
    return jg, tg


def test_model_grads_match_jax_grad(setup):
    jg, tg = _model_grads(setup)
    for j, t in zip(jax.tree_util.tree_leaves(jg), tg):
        np.testing.assert_allclose(_np(t), _np(j), **GRAD)


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 32)])
def test_rmsnorm_grads_match_jax_grad(shape):
    rng = np.random.default_rng(sum(shape))
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in "xy")
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: JL.rmsnorm(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ty = TL.rmsnorm(tx, tw, 1e-5)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(dy))
    np.testing.assert_allclose(_np(ty), _np(y), **FWD)
    np.testing.assert_allclose(_np(tdx), _np(jdx), **GRAD)
    np.testing.assert_allclose(_np(tdw), _np(jdw), **GRAD)


@pytest.mark.parametrize("masked", [0, 3])
def test_cross_entropy_grads_match_jax_grad(masked):
    rng = np.random.default_rng(masked)
    logits = (rng.standard_normal((2, 6, 40)) * 3).astype(np.float32)
    tgt = rng.integers(0, 40, (2, 6)).astype(np.int32)
    tgt[1, :masked] = -1
    jl, jd = jax.value_and_grad(JM.cross_entropy)(jnp.asarray(logits),
                                                  jnp.asarray(tgt))
    tlog = torch.from_numpy(logits).requires_grad_()
    tl = TM.cross_entropy(tlog, torch.from_numpy(tgt))
    (td,) = torch.autograd.grad(tl, (tlog,))
    np.testing.assert_allclose(_np(tl), _np(jl), **FWD)
    np.testing.assert_allclose(_np(td), _np(jd), **GRAD)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_custom_backwards_keep_the_compute_dtype(dtype):
    x = torch.randn(2, 4, 8, dtype=dtype, requires_grad=True)
    w = torch.ones(8, dtype=dtype, requires_grad=True)
    dx, dw = torch.autograd.grad(TL.rmsnorm(x, w).sum(), (x, w))
    assert dx.dtype == dtype and dw.dtype == dtype
    logits = torch.randn(2, 4, 16, dtype=dtype, requires_grad=True)
    loss = TM.cross_entropy(logits, torch.randint(0, 16, (2, 4)))
    assert loss.dtype == torch.float32
    (dl,) = torch.autograd.grad(loss, (logits,))
    assert dl.dtype == dtype


def test_attention_and_rope_match(setup):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
            for _ in "kv")
    pos = np.arange(8)
    for window in (None, 3):
        jo = JL.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              window=window)
        to = TL.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window)
        np.testing.assert_allclose(_np(to), _np(jo), **FWD)
    np.testing.assert_allclose(
        _np(TL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4)),
        _np(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4)), **FWD)


def test_one_adamw_step_matches(setup):
    jg, tg = _model_grads(setup)
    _, _, jparams, tparams, _, _ = setup
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = JO.adamw_init(jparams)
    jp, js, jmet = JO.adamw_update(JO.AdamWConfig(**cfg), jg, jopt, jparams)
    tgrads = params_from_jax(jax.device_get(jg), "cpu")
    tp, ts, tmet = TO.adamw_update(TO.AdamWConfig(**cfg), tgrads,
                                   TO.adamw_init(tparams), tparams)
    np.testing.assert_allclose(_np(tmet["grad_norm"]), _np(jmet["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tmet["lr"]), _np(jmet["lr"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 1
    for j, t in zip(jax.tree_util.tree_leaves((jp, js["m"], js["v"])),
                    tree_leaves((tp, ts["m"], ts["v"]))):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5)
    # the update is functional: the inputs are left as they were
    assert all(np.array_equal(a, _np(b)) for a, b in zip(
        tree_leaves(params_to_numpy(tparams)),
        tree_leaves(params_from_jax(jax.device_get(jparams), "cpu"))))


@pytest.mark.parametrize("step", [0, 3, 7, 12])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches(step, schedule):
    kw = dict(lr=3e-4, warmup_steps=4, total_steps=10, schedule=schedule)
    np.testing.assert_allclose(
        _np(TO.lr_at(TO.AdamWConfig(**kw), torch.tensor(step))),
        _np(JO.lr_at(JO.AdamWConfig(**kw), jnp.asarray(step))), rtol=1e-6)
