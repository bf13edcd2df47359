"""The Mamba and xLSTM blocks split over the model axis (``ssm_inner``,
``xl_inner``), on gloo CPU ranks (``launch.mesh.spawn``), f32, reduced
jamba-v0.1-52b (one 8-layer period: 7 Mamba, 1 attention, 4 MoE) and
reduced xlstm-125m (two [mLSTM, sLSTM] groups), against the port's
one-process step and serving from the same init:

  * the train step on meshes (data 1, model 2), (1, 4) and (2, 2): the
    loss and every gradient within rtol 1e-4 / atol 1e-6
    (``test_torch_tp.train_against_one_process``), the leaves that are
    whole on every rank and sliced by each (``conv_w``, ``conv_b``,
    ``dt_bias``, ``A_log``, ``D``, ``b_i``, ``b_f``, ``r``, ``bias``)
    named one by one, since a missing ``copy_to_tp`` leaves their
    gradient one rank's share. jamba's gradients are also allowed 1e-5
    of their leaf's largest entry (``test_torch_tp_moe.LEAF_RTOL``): its
    one-process f32 embedding gradient is itself 5.5e-6 past rtol 1e-4 /
    atol 1e-6 from the same step in float64, and the split's as far;
  * each rank holds only its slices: ``in_proj`` 2·d_inner/tp columns,
    ``out_proj`` d_inner/tp rows, ``wx`` 4d/tp columns, ``wff_u`` ff/tp;
  * prefill and four greedy decode steps on (1, 2) and (1, 4): logits
    within 1e-4; after the prefill and after every step each rank's
    Mamba ``h``/``conv`` and mLSTM ``conv`` equal ``specs.local_slice``
    of the one-process cache, the mLSTM ``C``/``n`` and the sLSTM
    states equal it whole (within 1e-4);
  * the collectives of one forward of each block kind: Mamba and mLSTM
    one all-to-all and two all-reduces, sLSTM one all-gather and one
    all-reduce;
  * the loss of the JAX package's jitted step on a (data 1, model 2)
    host mesh from the same init, within 1e-4;
  * outside a mesh nothing changed: reduced xlstm-125m's one-process
    step, and reduced jamba's and xlstm's prefill and decode, equal bit
    for bit those of the blocks as they were before the split, frozen in
    ``tests/_torch_unsplit_step.py`` (jamba's step is held there by
    ``test_torch_dp_exact.py::test_one_process_step_is_unchanged``).

Each spawned run has its own time limit.
"""
import dataclasses
import os
import pickle

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import state_from_jax
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X
from repro_torch.models.model import build_model
from repro_torch.sharding import specs as SH
from repro_torch.train.trainer import make_train_step, shard_state
from repro_torch.tree import tree_map
from tests.test_torch_dp_exact import _two_steps
from tests.test_torch_tp import (AXES, OPT, _masked_batch,
                                 train_against_one_process)
from tests.test_torch_tp_moe import LEAF_RTOL

RANK_TIMEOUT = 240
ARCHS = ("jamba-v0.1-52b", "xlstm-125m")
TRAIN_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
PROMPT, STEPS = 16, 4
# the leaves whole on every rank that each rank narrows to its channels
# or uses whole inside the split block, by block kind
WHOLE_LEAVES = {"mamba": ("conv_w", "conv_b", "dt_bias", "A_log", "D"),
                "mlstm": ("conv_w", "conv_b", "b_i", "b_f"),
                "slstm": ("r", "bias")}
# the states split over the model axis (their channel dim), by block kind
SPLIT_STATES = {"mamba": {"h": 2, "conv": 3}, "mlstm": {"conv": 3}}


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _leaf_rtol(arch):
    return LEAF_RTOL if arch.startswith("jamba") else 0.0


def _clone(cache):
    return tree_map(lambda t: t.clone(), cache)


def _serve(arch, shape):
    """Prefill and STEPS greedy decode steps in one process and on a (data,
    model) mesh, params as DTensors: the largest logit gap, and for every
    recurrent state after the prefill and each step its (whole shape,
    this rank's shape, gap to ``local_slice`` of the one-process
    state)."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, PROMPT),
                                     generator=gen, dtype=torch.int32)}
    logits, cache = model.prefill(params, batch, cache_len=PROMPT + STEPS)
    ref, fed, ref_caches = [logits], [], [_clone(cache)]
    for i in range(STEPS):
        fed.append(logits.argmax(-1, keepdim=True).int())
        logits, cache = model.decode_step(params, cache, fed[-1], PROMPT + i)
        ref.append(logits)
        ref_caches.append(_clone(cache))
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    with SH.activation_sharding(axes, mesh):
        logits, cache = model.prefill(dparams, batch,
                                      cache_len=PROMPT + STEPS)
        got, caches = [logits], [_clone(cache)]
        for i in range(STEPS):
            logits, cache = model.decode_step(dparams, cache, fed[i],
                                              PROMPT + i)
            got.append(logits)
            caches.append(_clone(cache))
    cspecs = model.cache_specs(ref_caches[0], axes)
    kinds = {b.name: b.kind for b in model.blocks}
    states = []
    for whole, mine in zip(ref_caches, caches):
        for name, kind in kinds.items():
            if kind not in WHOLE_LEAVES:
                continue
            for kk, t in whole[name].items():
                pl = SH.mesh_placements(cspecs[name][kk], mesh)
                local = mine[name][kk]
                want = SH.local_slice(t, SH.wrap_local(local, mesh, pl,
                                                       t.shape))
                gap = (float((local - want).abs().max())
                       if local.shape == want.shape else float("inf"))
                states.append((kind, kk, tuple(t.shape),
                               tuple(local.shape), gap))
    return {"gap": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "shape": [tuple(a.shape) for a in got] == [tuple(b.shape)
                                                      for b in ref],
            "states": states}


def _block_collectives(arch, shape):
    """Collectives of one no-grad forward of each recurrent block kind on
    its own, by kind, and the local shapes of the split leaves."""
    model = build_model(_cfg(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    apply = {"mamba": SSM.mamba_apply, "mlstm": X.mlstm_apply,
             "slstm": X.slstm_apply}
    x = torch.randn(2, 8, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    out = {"coll": {}, "local": {}}
    with SH.activation_sharding(axes, mesh), torch.no_grad():
        local = model.local_params(dparams)
        for blk in model.blocks:
            if blk.kind not in apply or blk.kind in out["coll"]:
                continue
            p = {k: v[0] for k, v in local["stack"][blk.name].items()}
            c0 = dict(SH.COLLECTIVES)
            apply[blk.kind](p, blk.spec, x)
            out["coll"][blk.kind] = {k: SH.COLLECTIVES[k] - c0[k]
                                     for k in c0}
            out["local"][blk.kind] = {k: tuple(v.shape)
                                      for k, v in local["stack"][blk.name]
                                      .items()}
    return out


def _ssm_rank(rank, world):
    out = {"train": {}, "serve": {}, "blocks": {}}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg)
        for shape in TRAIN_MESHES[world]:
            out["train"][(arch, shape)], _ = train_against_one_process(
                model, shape, _masked_batch(cfg), leaf_rtol=_leaf_rtol(arch))
        out["serve"][arch] = _serve(arch, (1, world))
        out["blocks"][arch] = _block_collectives(arch, (1, world))
    return out


@pytest.fixture(scope="module")
def ssm_tp():
    return {world: spawn(_ssm_rank, world, timeout=RANK_TIMEOUT)
            for world in (2, 4)}


def _train_cases():
    return [(w, a, s) for w, shapes in TRAIN_MESHES.items() for s in shapes
            for a in ARCHS]


@pytest.mark.parametrize("world,arch,shape", _train_cases(), ids=str)
def test_split_train_step_matches_one_process(ssm_tp, world, arch, shape):
    model = build_model(_cfg(arch))
    for r in ssm_tp[world]:
        t = r["train"][(arch, shape)]
        for got, want in zip(t["split"], t["one"]):
            assert abs(got - want) <= 1e-4 * abs(want) + 1e-6, (got, want)
        assert t["excess"] <= 0.0, max(t["leaves"].items(),
                                       key=lambda kv: kv[1])
        # the whole leaves a split block slices: named, each within bounds
        named = [f"stack/{b.name}/{leaf}" for b in model.blocks
                 for leaf in WHOLE_LEAVES.get(b.kind, ())]
        assert named and all(t["leaves"][n] <= 0.0 for n in named), \
            {n: t["leaves"][n] for n in named}


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_slices(ssm_tp, world):
    for arch in ARCHS:
        cfg = _cfg(arch)
        d = cfg.d_model
        for r in ssm_tp[world]:
            loc = r["blocks"][arch]["local"]
            if arch.startswith("jamba"):
                di = cfg.ssm.expand * d
                # stacked: a leading [n_groups] dim
                assert loc["mamba"]["in_proj"][1:] == (d, 2 * di // world)
                assert loc["mamba"]["out_proj"][1:] == (di // world, d)
                assert loc["mamba"]["conv_w"][1:] == (cfg.ssm.d_conv, di)
            else:
                dm = int(cfg.xlstm.proj_factor * d)
                ff = X.SLSTMSpec(d, cfg.n_heads, cfg.norm_eps).d_ff
                assert loc["mlstm"]["up_proj"][1:] == (d, 2 * dm // world)
                assert loc["mlstm"]["wq"][1:] == (dm // world, dm)
                assert loc["slstm"]["wx"][1:] == (d, 4 * d // world)
                assert loc["slstm"]["wff_u"][1:] == (d, ff // world)
                assert loc["slstm"]["r"][1:] == (4, cfg.n_heads,
                                                 d // cfg.n_heads,
                                                 d // cfg.n_heads)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_split_prefill_and_decode_match_one_process(ssm_tp, world, arch):
    for r in ssm_tp[world]:
        s = r["serve"][arch]
        assert s["shape"], s
        assert s["gap"] <= 1e-4, s["gap"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_keeps_its_state_slices(ssm_tp, world, arch):
    for r in ssm_tp[world]:
        states = r["serve"][arch]["states"]
        # every recurrent state, after the prefill and each decode step
        assert len(states) % (STEPS + 1) == 0 and states, states
        for kind, kk, whole, local, gap in states:
            want = list(whole)
            split_dim = SPLIT_STATES.get(kind, {}).get(kk)
            if split_dim is not None:
                want[split_dim] //= world
            assert local == tuple(want), (kind, kk, whole, local)
            assert gap <= 1e-4, (kind, kk, gap)


@pytest.mark.parametrize("world", [2, 4])
def test_one_forward_of_each_block_kind_issues_the_designed_collectives(
        ssm_tp, world):
    for r in ssm_tp[world]:
        coll = {**r["blocks"]["jamba-v0.1-52b"]["coll"],
                **r["blocks"]["xlstm-125m"]["coll"]}
        # the fused input projection's re-layout, x_proj's (the q, k, v,
        # o and gates' one tuple) all-reduce, the output projection's
        assert coll["mamba"] == {"all_reduce": 2, "all_gather": 0,
                                 "reduce_scatter": 0, "all_to_all": 1}, coll
        assert coll["mlstm"] == {"all_reduce": 2, "all_gather": 0,
                                 "reduce_scatter": 0, "all_to_all": 1}, coll
        # xw's all-gather, the FFN's all-reduce
        assert coll["slstm"] == {"all_reduce": 1, "all_gather": 1,
                                 "reduce_scatter": 0, "all_to_all": 0}, coll


_JAX_STEP = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.sharding.specs import make_axes, param_specs
from repro.train import AdamWConfig, init_state, make_train_step
from repro.train.trainer import state_dims
mesh = make_test_mesh((1, 2), ("data", "model"))
axes = make_axes(mesh)
out = {{}}
for arch in {archs!r}:
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg)
    state = init_state(model, jax.random.PRNGKey(0))
    batch = {{k: np.array(v) for k, v in TokenPipeline(
        cfg, 4, 32, seed=0).next().items()}}
    specs = param_specs(state_dims(model), state, axes)
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))
    step = jax.jit(make_train_step(model, AdamWConfig(
        warmup_steps=1, total_steps=8, grad_clip=0.0), axes=axes))
    with mesh:
        _, m = step(jax.device_put(state, sh),
                    {{k: jnp.asarray(v) for k, v in batch.items()}})
    out[arch] = (jax.device_get(state), batch, float(m["loss"]))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _jax_rank(rank, world, ref):
    out = {}
    for arch, (np_state, np_batch, _) in ref.items():
        model = build_model(_cfg(arch))
        mesh = make_test_mesh((1, 2), AXES, "cpu")
        axes = SH.make_axes(mesh)
        st = shard_state(model, state_from_jax(np_state, "cpu"), mesh, axes)
        _, m = make_train_step(model, OPT, mesh=mesh, axes=axes)(
            st, {k: torch.from_numpy(v) for k, v in np_batch.items()})
        out[arch] = float(m["loss"])
    return out


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    from tests.conftest import run_subprocess
    path = os.path.join(str(tmp_path_factory.mktemp("ssm")), "ref.pkl")
    run_subprocess(_JAX_STEP.format(archs=ARCHS, path=path), devices=2,
                   timeout=300)
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ranks = spawn(_jax_rank, 2, ref, timeout=RANK_TIMEOUT)
    assert ranks[0] == ranks[1]          # the model ranks report one step
    return {arch: (ref[arch][2], ranks[0][arch]) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_split_loss_matches_the_reference_jitted_step(jax_losses, arch):
    want, got = jax_losses[arch]
    assert abs(got - want) <= 1e-4, (got, want)


def _prefill_decode_bytes(arch):
    """Logits of a one-process prefill and two decode steps, as bytes."""
    model = build_model(_cfg(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (2, PROMPT),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  cache_len=PROMPT + 2)
    got = [logits]
    for i in range(2):
        logits, cache = model.decode_step(
            params, cache, logits.argmax(-1, keepdim=True).int(), PROMPT + i)
        got.append(logits)
    return [t.numpy().tobytes() for t in got]


def _frozen(fn, *args):
    from tests._torch_unsplit_step import unsplit
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        now = fn(*args)
        with unsplit():
            before = fn(*args)
    finally:
        torch.set_num_threads(n)
    return now, before


def test_one_process_xlstm_step_is_unchanged():
    now, before = _frozen(_two_steps, "xlstm-125m")
    assert now == before


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_serving_is_unchanged(arch):
    now, before = _frozen(_prefill_decode_bytes, arch)
    assert now == before
