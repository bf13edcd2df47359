"""The port's models against the JAX package's, from the same init.

``jax.random`` cannot be replayed in torch, so the JAX init is handed to
the port through ``repro_torch.convert`` and the inputs are made with
numpy. All in f32 on the CPU, where XLA and torch still sum in different
orders: forward values agree within rtol=atol=1e-5, gradients within
1e-4, one AdamW step within 1e-5. The dense model (reduced repro-100m)
and the MoE and hybrid ones (reduced jamba, llama4-scout and
llama4-maverick) are held to the same tolerances, their loss with its
MoE aux term, except their logits: within rtol=1e-5, atol=2e-5. Reduced
jamba's run through 16 blocks and differ from the reference's by up to
1.4e-5 near 0 (|logits| up to 3.8); an exact f64 scan in place of the
doubling one leaves 1.3e-5, so the matmuls' summation order makes it, not
the scan. Their prefill-then-decode agrees with the full forward within
2e-4, as the reference's own test holds it. Reduced xlstm-125m,
seamless-m4t-medium (its encoder over numpy frames) and internvl2-2b (its
patch embeddings before the tokens) are held to the dense tolerances:
param trees, group programs and caches equal, logits and loss within
1e-5, grads within 1e-4, prefill-then-decode as above. A CPU generator still
draws the init it drew before the draw moved to the generator's device
(a pinned digest).
"""
import dataclasses
import hashlib

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
from repro_torch.ckpt.layout import host_array
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


# ---------------------------------------------------------------------------
# The init drawn from a CPU generator, pinned
# ---------------------------------------------------------------------------

def test_cpu_generator_draws_the_same_init_as_before():
    """Reduced repro-100m (bf16) from a CPU generator seeded 0: the digest
    of its param bytes as drawn before ``ParamBuilder`` drew on the
    generator's own device."""
    model = TM.build_model(treduced(tget_config("repro-100m")))
    h = hashlib.sha256()
    for t in tree_leaves(model.init(torch.Generator().manual_seed(0),
                                    "cpu")):
        h.update(host_array(t).tobytes())
    assert h.hexdigest() == ("99e09fbbd92f2e59dabe8f618f184907"
                             "f1869caa1f88c73e3b18e4d3836e8e24")


# ---------------------------------------------------------------------------
# MoE and hybrid (Mamba + attention) stacks
# ---------------------------------------------------------------------------

HYBRID = ["jamba-v0.1-52b", "llama4-scout-17b-a16e",
          "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", params=HYBRID)
def hybrid(request):
    arch = request.param
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(treduced(tget_config(arch)), dtype="float32")
    jm, tm = JM.build_model(jcfg), TM.build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    targets[1, :2] = -1
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "targets": torch.from_numpy(targets)}
    return jm, tm, jparams, tparams, jbatch, tbatch


def test_hybrid_param_tree_and_blocks_match(hybrid):
    jm, tm, jparams, tparams, _, _ = hybrid
    assert [(b.kind, b.name) for b in tm.blocks] == \
        [(b.kind, b.name) for b in jm.blocks]
    assert tm.n_groups == jm.n_groups
    jl = [(tuple(k.key for k in path), tuple(x.shape)) for path, x in
          jax.tree_util.tree_flatten_with_path(jparams)[0]]
    ours = tm.init(torch.Generator().manual_seed(0), "cpu")
    for tree in (tparams, ours):
        assert [(p, tuple(x.shape)) for p, x in leaves_with_path(tree)] == jl
    jc = jax.tree_util.tree_flatten_with_path(jm.init_cache(B, 24))[0]
    tc = tm.init_cache(B, 24, "cpu")
    assert [(p, tuple(x.shape), str(x.dtype)[6:]) for p, x in
            leaves_with_path(tc)] == \
        [(tuple(k.key for k in p), tuple(x.shape), str(x.dtype))
         for p, x in jc]
    assert tm.cache_dims() == jm.cache_dims()


def test_hybrid_logits_loss_and_aux_match(hybrid):
    jm, tm, jparams, tparams, jbatch, tbatch = hybrid
    cfg = tm.cfg
    x = JL.embed_apply(jparams["embed"], jbatch["tokens"], jm.dtype)
    x, jaux = JT.stack_forward(jparams["stack"], jm.blocks, x,
                               jnp.arange(S), remat=False)
    x = JL.rmsnorm(x, jparams["embed"]["final_norm"], cfg.norm_eps)
    jlogits = JL.unembed_apply(jparams["embed"], x, cfg.tie_embeddings)
    x = TL.embed_apply(tparams["embed"], tbatch["tokens"], tm.dtype)
    x, taux = TT.stack_forward(tparams["stack"], tm.blocks, x,
                               torch.arange(S), remat=False)
    x = TL.rmsnorm(x, tparams["embed"]["final_norm"], cfg.norm_eps)
    tlogits = TL.unembed_apply(tparams["embed"], x, cfg.tie_embeddings)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=1e-5,
                               atol=2e-5)
    assert float(taux) > 0
    np.testing.assert_allclose(_np(taux), _np(jaux), **FWD)
    jl, jmet = jm.loss(jparams, jbatch, remat=False)
    for remat in (False, True):
        tl, tmet = tm.loss(tparams, tbatch, remat=remat)
        np.testing.assert_allclose(_np(tl), _np(jl), **FWD)
        np.testing.assert_allclose(_np(tmet["moe_aux"]), _np(jmet["moe_aux"]),
                                   **FWD)
        np.testing.assert_allclose(
            _np(tl), _np(tmet["ce"] + 0.01 * tmet["moe_aux"]), rtol=1e-6)


def test_hybrid_grads_match(hybrid):
    jm, tm, jparams, tparams, jbatch, tbatch = hybrid
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jbatch, remat=False)[0]))(
        jparams)
    req = [t.requires_grad_() for t in tree_leaves(tparams)]
    try:
        tg = torch.autograd.grad(tm.loss(tparams, tbatch, remat=True)[0], req)
    finally:
        for t in req:
            t.requires_grad_(False)
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **GRAD)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-scout-17b-a16e"])
def test_hybrid_prefill_decode_matches_forward(arch):
    """The reference's ``test_prefill_decode_matches_forward`` on the port:
    prefill 15 tokens, decode the 16th; its logits equal the full
    prefill's within 2e-4, and the JAX package's decode logits within
    1e-5."""
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(treduced(tget_config(arch)), dtype="float32")
    jm, tm = JM.build_model(jcfg), TM.build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    n = 16
    rng = np.random.Generator(np.random.PCG64(1))
    tokens = rng.integers(0, jcfg.vocab_size, (1, n)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    full, _ = tm.prefill(tparams, {"tokens": tt}, cache_len=n + 1)
    _, cache = tm.prefill(tparams, {"tokens": tt[:, :-1]}, cache_len=n + 1)
    dec, _ = tm.decode_step(tparams, cache, tt[:, -1:], n - 1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=2e-4, atol=2e-4)
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :-1])},
                           cache_len=n + 1)
    jdec, _ = jm.decode_step(jparams, jcache, jnp.asarray(tokens[:, -1:]),
                             jnp.int32(n - 1))
    np.testing.assert_allclose(_np(dec), _np(jdec), **FWD)


# ---------------------------------------------------------------------------
# xLSTM, encoder-decoder and vision-frontend models
# ---------------------------------------------------------------------------

FAMILIES = ["xlstm-125m", "seamless-m4t-medium", "internvl2-2b"]


def _family_batch(cfg, S, seed):
    """tokens and targets, plus seamless's encoder frames or internvl2's
    patch embeddings (``frontend_len`` of them before the ``S - F``
    tokens), from one numpy seed, as ``tests/conftest.py`` makes them."""
    rng = np.random.default_rng(seed)
    F = cfg.frontend_len if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - F)),
           "targets": rng.integers(0, cfg.vocab_size, (B, S))}
    out = {k: v.astype(np.int32) for k, v in out.items()}
    out["targets"][0, -2:] = -1
    extra = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
    if extra:
        out[extra] = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                      * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg = dataclasses.replace(reduced(get_config(request.param)),
                               dtype="float32")
    tcfg = dataclasses.replace(treduced(tget_config(request.param)),
                               dtype="float32")
    jm, tm = JM.build_model(jcfg), TM.build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    return (jm, tm, jparams, tparams) + _family_batch(jcfg, S, 5)


def test_family_param_tree_blocks_and_cache_match(family):
    jm, tm, jparams, tparams, _, _ = family
    assert [(b.kind, b.name) for b in tm.blocks] == \
        [(b.kind, b.name) for b in jm.blocks]
    assert tm.n_groups == jm.n_groups and tm.enc_groups == jm.enc_groups
    jl = [(tuple(k.key for k in path), tuple(x.shape)) for path, x in
          jax.tree_util.tree_flatten_with_path(jparams)[0]]
    ours = tm.init(torch.Generator().manual_seed(0), "cpu")
    for tree in (tparams, ours):
        assert [(p, tuple(x.shape)) for p, x in leaves_with_path(tree)] == jl
    jc = jax.tree_util.tree_flatten_with_path(jm.init_cache(B, 24))[0]
    tc = tm.init_cache(B, 24, "cpu")
    assert [(p, tuple(x.shape), str(x.dtype)[6:]) for p, x in
            leaves_with_path(tc)] == \
        [(tuple(k.key for k in p), tuple(x.shape), str(x.dtype))
         for p, x in jc]
    assert tm.cache_dims() == jm.cache_dims()


def _family_logits(m, p, batch, stack_forward, rmsnorm, unembed):
    x, positions, enc_out = m._inputs(p, batch, remat=False)[:3]
    x, _ = stack_forward(p["stack"], m.blocks, x, positions, enc_out=enc_out,
                         remat=False)
    x = rmsnorm(x, p["embed"]["final_norm"], m.cfg.norm_eps)
    return unembed(p["embed"], x, m.cfg.tie_embeddings)


def test_family_logits_and_loss_match(family):
    jm, tm, jparams, tparams, jbatch, tbatch = family
    np.testing.assert_allclose(
        _np(_family_logits(tm, tparams, tbatch, TT.stack_forward,
                           TL.rmsnorm, TL.unembed_apply)),
        _np(_family_logits(jm, jparams, jbatch, JT.stack_forward,
                           JL.rmsnorm, JL.unembed_apply)), **FWD)
    jl, jmet = jm.loss(jparams, jbatch, remat=False)
    for remat in (False, True):
        tl, tmet = tm.loss(tparams, tbatch, remat=remat)
        np.testing.assert_allclose(_np(tl), _np(jl), **FWD)
        np.testing.assert_allclose(_np(tmet["ce"]), _np(jmet["ce"]), **FWD)


def test_family_grads_match(family):
    jm, tm, jparams, tparams, jbatch, tbatch = family
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jbatch, remat=False)[0]))(
        jparams)
    req = [t.requires_grad_() for t in tree_leaves(tparams)]
    try:
        tg = torch.autograd.grad(tm.loss(tparams, tbatch, remat=True)[0], req)
    finally:
        for t in req:
            t.requires_grad_(False)
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **GRAD)


def test_family_prefill_decode_matches_forward(family):
    """The reference's ``test_prefill_decode_matches_forward`` for the three
    families: prefill the prompt but its last token, decode that token at
    its position (past the patch embeddings for internvl2; the encoder's
    frames are not decoder positions for seamless); its logits equal the
    full prefill's within 2e-4, and the JAX package's decode logits within
    1e-5."""
    jm, tm, jparams, tparams, jbatch, tbatch = family
    n = tbatch["tokens"].shape[1]
    pos = n - 1 + (tm.cfg.frontend_len if tm.cfg.family == "vlm" else 0)
    prompt = lambda b, k: {kk: v[:, :k] if kk == "tokens" else v
                           for kk, v in b.items() if kk != "targets"}
    full, _ = tm.prefill(tparams, prompt(tbatch, n), cache_len=pos + 1)
    _, cache = tm.prefill(tparams, prompt(tbatch, n - 1), cache_len=pos + 1)
    dec, _ = tm.decode_step(tparams, cache, tbatch["tokens"][:, -1:], pos)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=2e-4, atol=2e-4)
    _, jcache = jm.prefill(jparams, prompt(jbatch, n - 1), cache_len=pos + 1)
    jdec, _ = jm.decode_step(jparams, jcache, jbatch["tokens"][:, -1:],
                             jnp.int32(pos))
    np.testing.assert_allclose(_np(dec), _np(jdec), **FWD)


@pytest.mark.parametrize("arch", FAMILIES)
def test_build_group_gives_the_reference_blocks(arch):
    """The group program of each family, and seamless's encoder group:
    the reference's block kinds, names, specs and depths. A field the
    port's spec has and the reference's lacks (granite's attention scale
    and residual multiplier) holds its default, which computes as the
    reference does."""
    jcfg, tcfg = reduced(get_config(arch)), treduced(tget_config(arch))
    as_fields = lambda spec: {f.name: getattr(spec, f.name)
                              for f in dataclasses.fields(spec)}
    pairs = [(JT.build_group(jcfg), TT.build_group(tcfg))]
    if jcfg.encoder is not None:
        pairs.append((JT.build_encoder_group(jcfg),
                      TT.build_encoder_group(tcfg)))
    kinds = {"xlstm-125m": {"mlstm", "slstm"},
             "seamless-m4t-medium": {"attn", "cross_attn", "mlp"},
             "internvl2-2b": {"attn", "mlp"}}[arch]
    assert {b.kind for b in pairs[0][1][0]} == kinds
    for (jblocks, jn), (tblocks, tn) in pairs:
        assert tn == jn
        assert [(b.kind, b.name) for b in tblocks] == \
            [(b.kind, b.name) for b in jblocks]
        for jb, tb in zip(jblocks, tblocks):
            jf, tf = as_fields(jb.spec), as_fields(tb.spec)
            if "cfg" in jf:                  # the xLSTM config dataclass
                jf["cfg"], tf["cfg"] = as_fields(jf["cfg"]), \
                    as_fields(tf["cfg"])
            extra = {f.name: f.default for f in dataclasses.fields(tb.spec)
                     if f.name not in jf}
            assert {k: tf.pop(k) for k in extra} == extra, tb.name
            assert tf == jf, (tb.name, tf, jf)
