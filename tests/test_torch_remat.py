"""The selective remat ``remat="save_moe"`` (``transformer.stack_forward``)
against full remat, no remat and the JAX package's policy of the same
name, f32, reduced MoE configs (llama4-scout-17b-a16e: a MoE layer a
group with a shared expert; jamba-v0.1-52b: a MoE every other layer of
its 8-layer period, beside Mamba and attention blocks):

  * the port's loss and gradients under ``"save_moe"`` against the JAX
    package's ``model.loss(..., remat="save_moe")`` from the same init
    and batch: the loss within rtol 1e-5 / atol 1e-4, every gradient
    within rtol 1e-4 / atol 1e-4 (``test_torch_moe.py``'s tolerances);
  * in one process ``"save_moe"``, ``True`` and ``False`` give the same
    loss and gradients bit for bit (a dense model's too, whose groups
    keep nothing more): the recompute forms each tensor by the same ops
    in the same order as full remat's, and reads the kept ones back;
  * on two gloo CPU ranks (``launch.mesh.spawn``), mesh (data 1, model
    2), the experts split over ``ep``, with ``seq_shard`` off and on: the
    gradients under ``"save_moe"`` equal full remat's bit for bit, the
    forward issues one ep all-gather a MoE layer under both, and the
    backward one fewer a MoE layer under ``"save_moe"`` (none), read
    from ``specs.collective_log()``;
  * any other policy string raises ``ValueError``, from ``Model.loss``,
    ``make_train_step`` and ``build_cell`` (the reference takes it for
    full remat).

Each spawned run has its own time limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import model as TM
from repro_torch.sharding import specs as SH
from repro_torch.tree import tree_leaves, tree_unflatten

FWD = dict(rtol=1e-5, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ("llama4-scout-17b-a16e", "jamba-v0.1-52b")
RANK_TIMEOUT = 240
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(arch):
    return dataclasses.replace(treduced(tget_config(arch)), dtype="float32")


def _batch(cfg, seed=0):
    return {k: torch.as_tensor(v) for k, v in
            TokenPipeline(cfg, B, S, seed=seed).next().items()}


def _loss_and_grads(model, params, batch, remat):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, aux = model.loss(tree_unflatten(params, leaves), batch,
                           remat=remat)
    return loss.detach(), aux, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_save_moe_loss_and_grads_match_the_reference(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    jm, tm = JM.build_model(cfg), TM.build_model(_tcfg(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    batch = _batch(tm.cfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, remat="save_moe"), has_aux=True)(
        jparams)
    tl, taux, tg = _loss_and_grads(tm, tparams, batch, "save_moe")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(taux["moe_aux"].detach().numpy(),
                               np.asarray(jaux["moe_aux"]), **FWD)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for j, t in zip(jleaves, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD)


@pytest.mark.parametrize("arch", MOE_ARCHS + ("internlm2-1.8b",))
def test_remat_policies_give_the_same_gradients_in_one_process(arch):
    model = TM.build_model(_tcfg(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(model.cfg, seed=1)
    want_l, _, want = _loss_and_grads(model, params, batch, True)
    for remat in ("save_moe", False):
        loss, _, grads = _loss_and_grads(model, params, batch, remat)
        assert torch.equal(loss, want_l), (remat, loss, want_l)
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), remat


def _ep_gathers(log):
    """The all-gathers the MoE layers issue (the expert output's, over
    ep)."""
    return sum(r["kind"] == "all_gather" and r["site"].startswith("models.moe")
               for r in log)


def _split(model, params, batch, remat, seq_shard):
    mesh = make_test_mesh((1, 2), ("data", "model"), "cpu")
    axes = SH.make_axes(mesh, seq_shard=seq_shard)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)),
        SH.param_specs(model.param_dims(), params, axes), params)
    with SH.activation_sharding(axes, mesh):
        local = model.local_params(dparams)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(local)]
        with SH.collective_log() as fwd:
            loss, _ = model.loss(tree_unflatten(local, leaves), batch,
                                 remat=remat)
        with SH.collective_log() as bwd:
            grads = torch.autograd.grad(loss, leaves)
    return {"loss": loss.detach(), "grads": grads,
            "fwd": _ep_gathers(fwd), "bwd": _ep_gathers(bwd),
            "reduce_scatters": sum(r["kind"] == "reduce_scatter"
                                   for r in fwd + bwd)}


def _remat_rank(rank, world):
    out = {}
    for arch in MOE_ARCHS:
        model = TM.build_model(_tcfg(arch))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        batch = _batch(model.cfg, seed=2)
        for sp in (False, True):
            full = _split(model, params, batch, True, sp)
            sel = _split(model, params, batch, "save_moe", sp)
            out[(arch, sp)] = {
                "loss_equal": bool(torch.equal(full["loss"], sel["loss"])),
                "grads_equal": all(torch.equal(a, b) for a, b in
                                   zip(full["grads"], sel["grads"])),
                "n_moe": model.n_groups * sum(b.kind == "moe"
                                              for b in model.blocks),
                **{f"{k}_{n}": r[k] for n, r in (("full", full),
                                                  ("sel", sel))
                   for k in ("fwd", "bwd", "reduce_scatters")}}
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_remat_rank, 2, timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("seq_shard", [False, True], ids=["sp_off", "sp_on"])
def test_save_moe_split_over_ep_gives_full_remats_gradients(ranks, arch,
                                                            seq_shard):
    for r in ranks:
        c = r[(arch, seq_shard)]
        assert c["loss_equal"] and c["grads_equal"], c
        # the sequence split is on where asked: its reduce-scatters
        assert (c["reduce_scatters_sel"] > 0) == seq_shard, c
        assert c["reduce_scatters_sel"] == c["reduce_scatters_full"], c


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("seq_shard", [False, True], ids=["sp_off", "sp_on"])
def test_save_moe_backward_gathers_the_experts_once_fewer_a_layer(
        ranks, arch, seq_shard):
    for r in ranks:
        c = r[(arch, seq_shard)]
        n = c["n_moe"]
        assert c["fwd_full"] == c["fwd_sel"] == n, c
        assert c["bwd_full"] == n and c["bwd_sel"] == 0, c


def test_an_unknown_remat_policy_raises():
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import make_train_step
    model = TM.build_model(_tcfg("llama4-scout-17b-a16e"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="save_everything"):
        model.loss(params, _batch(model.cfg), remat="save_everything")
    with pytest.raises(ValueError, match="save_dots"):
        make_train_step(model, AdamWConfig(), remat="save_dots")


def test_build_cell_refuses_an_unknown_policy():
    """Before it builds anything (so no mesh is needed to see it)."""
    from repro_torch.launch.lowering import build_cell
    with pytest.raises(ValueError, match="save_nothing"):
        build_cell("llama4-scout-17b-a16e", "train_4k", None,
                   remat="save_nothing")
