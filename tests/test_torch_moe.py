"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, from the same (JAX) init and numpy inputs.

  * top-2 routing (reduced jamba) and top-1 with a shared expert (reduced
    llama4-scout): output within rtol=1e-5, atol=1e-4 (it reaches ~35 in
    magnitude, where an f32 ulp is 4e-6) and aux loss within 1e-6 in
    f32, grads within 1e-4;
  * a router rigged to send every token's first choice to expert 0, so
    it overflows its capacity: the same tokens are dropped as in the
    reference (equal outputs), and they differ from a run with room for
    all of them;
  * bf16 router logits with deliberate ties: the same experts chosen as
    ``lax.top_k`` (the lower index first), and outputs within two bf16
    ulps at their scale (0.25 at |y| < 64) of the reference's, which
    rounds its intermediates elsewhere;
  * the capacity rule (at least 4, a multiple of 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE
from repro_torch.tree import leaves_with_path

FWD = dict(rtol=1e-5, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"top2": "jamba-v0.1-52b", "top1_shared": "llama4-scout-17b-a16e"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(case, dtype="float32", **moe_changes):
    arch = ARCHS[case]
    out = []
    for get, red, mod in ((get_config, reduced, JMoE),
                          (tget_config, treduced, TMoE)):
        cfg = dataclasses.replace(red(get(arch)), dtype=dtype)
        moe = dataclasses.replace(cfg.moe, **moe_changes)
        out.append(mod.MoESpec(cfg.d_model, moe, cfg.mlp_act, cfg.norm_eps,
                               d_ff_shared=cfg.d_ff if moe.shared_expert
                               else 0))
    return out


def _params(jspec, dtype=jnp.float32):
    b = JL.ParamBuilder(jax.random.PRNGKey(0), dtype)
    JMoE.moe_init(b, jspec)
    return b.params


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _both(jspec, tspec, jp, x, dtype=np.float32):
    jy, jaux = JMoE.moe_apply(jp, jspec, jnp.asarray(x).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32))
    tp = params_from_jax(jax.device_get(jp), "cpu")
    tx = torch.from_numpy(x)
    ty, taux = TMoE.moe_apply(tp, tspec, tx.to(torch.bfloat16)
                              if dtype == "bf16" else tx)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_init_names_shapes_and_dims_match(case):
    jspec, tspec = _specs(case)
    jb = JL.ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    JMoE.moe_init(jb, jspec)
    tb = TL.ParamBuilder(torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    TMoE.moe_init(tb, tspec)
    assert [(p, tuple(t.shape)) for p, t in leaves_with_path(tb.params)] == \
        [(tuple(k.key for k in p), tuple(a.shape)) for p, a in
         jax.tree_util.tree_flatten_with_path(jb.params)[0]]
    assert tb.dims == jb.dims


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_moe_apply_and_aux_match(case):
    jspec, tspec = _specs(case)
    jp = _params(jspec)
    (jy, jaux), (ty, taux) = _both(jspec, tspec, jp, _x(2, 16, jspec.d_model))
    np.testing.assert_allclose(_np(ty), _np(jy), **FWD)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(_np(taux), _np(jaux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_moe_grads_match(case):
    jspec, tspec = _specs(case)
    jp = _params(jspec)
    x, dy = _x(2, 16, jspec.d_model, 2), _x(2, 16, jspec.d_model, 3)

    def jf(p, x):
        y, aux = JMoE.moe_apply(p, jspec, x)
        return jnp.sum(y * dy) + aux
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: t.requires_grad_() for k, t in
          params_from_jax(jax.device_get(jp), "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMoE.moe_apply(tp, tspec, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux,
                                [tx, *tp.values()])
    np.testing.assert_allclose(_np(grads[0]), _np(jgx), **GRAD)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(_np(g), _np(jgp[k]), err_msg=k, **GRAD)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_tokens_past_capacity_are_dropped_as_in_the_reference(case):
    """Every token's first choice is expert 0: with S = 32 it holds
    ``C`` of them and drops the rest, in s-major order."""
    jspec, tspec = _specs(case)
    S, E = 32, jspec.cfg.num_experts
    C = TMoE.moe_capacity(S, tspec.cfg)
    assert C == JMoE.moe_capacity(S, jspec.cfg) < S
    jp = dict(_params(jspec))
    router = np.array(jp["router"])
    router[:, 0] = 0.0
    router[0, 0] = 1.0                 # a large feature 0 lifts expert 0's
    jp["router"] = jnp.asarray(router)  # logit above every other's
    x = _x(1, S, jspec.d_model, 4)
    x[..., 0] = 30.0
    (jy, jaux), (ty, taux) = _both(jspec, tspec, jp, x)
    np.testing.assert_allclose(_np(ty), _np(jy), **FWD)
    np.testing.assert_allclose(_np(taux), _np(jaux), rtol=1e-6, atol=1e-6)
    # with room for every token, only the tokens past C change
    jroomy, troomy = _specs(case, capacity_factor=float(E))
    (jr, _), (tr, _) = _both(jroomy, troomy, jp, x)
    np.testing.assert_allclose(_np(tr), _np(jr), **FWD)
    same = np.all(np.isclose(_np(ty), _np(tr), **FWD), axis=-1)[0]
    assert same[:C].all() and not same[C:].any()


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_tied_bf16_logits_choose_the_lower_expert_first(case):
    """Router columns 1 and 2 equal, and both above 0 and 3: in bf16 every
    token's logits tie, and both packages take expert 1 before 2."""
    jspec, tspec = _specs(case, dtype="bfloat16")
    jp = dict(_params(jspec, jnp.bfloat16))
    router = np.asarray(jax.device_get(jp["router"]), np.float32)
    router[:, 2] = router[:, 1]
    router[:, [0, 3]] = router[:, [1]] - 0.25
    jp["router"] = jnp.asarray(router, jnp.bfloat16)
    x = np.abs(_x(2, 8, jspec.d_model, 5))
    tp = params_from_jax(jax.device_get(jp), "cpu")
    jh = JL.rmsnorm(jnp.asarray(x, jnp.bfloat16), jp["norm"], jspec.norm_eps)
    jprobs = jax.nn.softmax((jh @ jp["router"]).astype(jnp.float32), -1)
    th = TL.rmsnorm(torch.from_numpy(x).to(torch.bfloat16), tp["norm"],
                    tspec.norm_eps)
    tprobs = torch.softmax((th @ tp["router"]).float(), -1)
    assert bool((tprobs[..., 1] == tprobs[..., 2]).all())
    K = jspec.cfg.top_k
    _, jidx = jax.lax.top_k(jprobs, K)
    _, tidx = TMoE.top_k(tprobs, K)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx[..., 0] == 1).all()
    _, tidx_j = TMoE.top_k(torch.from_numpy(np.array(jprobs)), K)
    np.testing.assert_array_equal(tidx_j.numpy(), np.asarray(jidx))
    (jy, jaux), (ty, taux) = _both(jspec, tspec, jp, x, "bf16")
    assert ty.dtype == torch.bfloat16
    assert float(np.abs(_np(jy)).max()) < 64
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=0.25)
    np.testing.assert_allclose(_np(taux), _np(jaux), rtol=1e-3)


@pytest.mark.parametrize("seq", [1, 5, 16, 32, 512])
def test_capacity_rule_matches(seq):
    for case in ARCHS:
        jspec, tspec = _specs(case)
        c = TMoE.moe_capacity(seq, tspec.cfg)
        assert c == JMoE.moe_capacity(seq, jspec.cfg)
        assert c >= 4 and c % 4 == 0
