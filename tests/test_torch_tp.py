"""The model-axis split of the forward (the port of ``constrain``), on
gloo CPU ranks (``launch.mesh.spawn``), f32, reduced configs, against the
port's one-process forward and step from the same init:

  * the train step of reduced internlm2-1.8b (4 heads, 2 kv heads, head
    dim 32) on meshes (data 1, model 2), (1, 4) and (2, 2): the loss and
    every gradient within rtol 1e-4 / atol 1e-6 (the gradient read from
    AdamW's first moment with clipping off, m = (1 - b1) g). Bit
    equality is not asked for: the split adds the heads' and ff's
    partial sums across ranks, in another order than one GEMM does. At
    (1, 4) the two kv heads do not split over four ranks, so the KV
    projections stay whole and each rank reads the kv head of its q head;
    the same for reduced seamless-m4t-medium (the split encoder and
    cross-attention), internvl2-2b and gemma3-12b on (1, 2) and (1, 4);
  * each rank holds only its slices: the q projection of 4/tp heads, the
    MLP's ff/tp columns and the vocab/tp rows;
  * prefill and four greedy decode steps of reduced internlm2,
    llama4-scout-17b-a16e, gemma3-12b (windowed layers),
    seamless-m4t-medium (the encoder and cross-attention) and
    internvl2-2b (patch embeddings) on (1, 2) and (1, 4), params as
    DTensors laid out by ``param_specs(param_dims())``: last-position
    and decode logits within 1e-4; at (1, 4) the KV caches (and the
    cross-attention memory) split over head_dim and every decode step of
    every attention layer takes the plain head_dim path
    (``HEADDIM_TP_CALLS`` within the decode steps);
  * the collectives of one forward: one all-reduce after each attention
    and each MLP block, one for the vocab-parallel embedding lookup and
    three for the vocab-parallel CE (row max, Σexp, target logit); no
    all-gather and no all-to-all.

``tests/test_torch_tp_moe.py`` holds the expert split. Each spawned run
has its own time limit.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.obs.telemetry import registry
from repro_torch.sharding import specs as SH
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_state, make_train_step,
                                       shard_state)
from repro_torch.tree import leaves_with_path, tree_leaves

RANK_TIMEOUT = 180
AXES = ("data", "model")
OPT = AdamWConfig(warmup_steps=1, total_steps=8, grad_clip=0.0)
B1 = OPT.b1
TRAIN_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
# the other families' train steps on (1, world): cross-attention and the
# split encoder, patch embeddings, windowed attention
TRAIN_FAMILIES = ("seamless-m4t-medium", "internvl2-2b", "gemma3-12b")
# dense, MoE, windowed (gemma3: 5 of 6 layers local, window 8 < the
# prompt), enc-dec (cross-attention over the encoder memory), vlm
SERVE_ARCHS = ("internlm2-1.8b", "llama4-scout-17b-a16e", "gemma3-12b",
               "seamless-m4t-medium", "internvl2-2b")
PROMPT, STEPS = 16, 4


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def train_against_one_process(model, shape, batch, use_fsdp=False,
                              steps=1, leaf_rtol=0.0):
    """``steps`` steps in one process and on a (data, model) mesh: the
    losses, the largest excess of the gradients over rtol 1e-4 / atol
    1e-6 (plus ``leaf_rtol`` of the leaf's largest gradient) after the
    first step, that excess leaf by leaf (``leaves``, by path), and the
    state on the mesh."""
    state = init_state(model, 0, "cpu")
    single = make_train_step(model, OPT)
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh, use_fsdp=use_fsdp)
    st = shard_state(model, state, mesh, axes)
    split = make_train_step(model, OPT, mesh=mesh, axes=axes)
    one_losses, losses, leaves = [], [], None
    for k in range(steps):
        b = batch if k == 0 else TokenPipeline(model.cfg, 4, 32,
                                               seed=k).next("cpu")
        state, m1 = single(state, b)
        st, m2 = split(st, b)
        one_losses.append(float(m1["loss"]))
        losses.append(float(m2["loss"]))
        if k == 0:
            leaves = {
                "/".join(path): float(
                    ((SH.full_tensor(a) - b_) / (1 - B1)).abs()
                    .sub(1e-6 + 1e-4 * (b_ / (1 - B1)).abs()
                         + leaf_rtol * (b_ / (1 - B1)).abs().max()).max())
                for (path, a), b_ in zip(
                    leaves_with_path(st["opt_state"]["m"]),
                    tree_leaves(state["opt_state"]["m"]))}
    return {"one": one_losses, "split": losses,
            "excess": max(leaves.values()), "leaves": leaves}, st


def _masked_batch(cfg):
    b = TokenPipeline(cfg, 4, 32, seed=0).next("cpu")
    b["targets"] = b["targets"].clone()
    b["targets"][:2, 4:] = -1
    return b


def serve_against_one_process(arch, shape):
    """Prefill and STEPS greedy decode steps in one process and on a
    (data, model) mesh, params as DTensors: the largest logit gap and the
    head_dim decodes."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, PROMPT),
                                     generator=gen, dtype=torch.int32)}
    extra = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
    if extra:
        batch[extra] = torch.randn(4, cfg.frontend_len, cfg.d_model,
                                   generator=gen) * 0.02
    # a vlm's prompt starts with its patch embeddings
    start = PROMPT + (cfg.frontend_len if cfg.family == "vlm" else 0)
    logits, cache = model.prefill(params, batch, cache_len=start + STEPS)
    ref, fed = [logits], []
    for i in range(STEPS):
        fed.append(logits.argmax(-1, keepdim=True).int())
        logits, cache = model.decode_step(params, cache, fed[-1], start + i)
        ref.append(logits)
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    with SH.activation_sharding(axes, mesh):
        logits, cache = model.prefill(dparams, batch,
                                      cache_len=start + STEPS)
        got = [logits]
        h0 = registry().value(L.HEADDIM_TP_CALLS)
        for i in range(STEPS):
            logits, cache = model.decode_step(dparams, cache, fed[i],
                                              start + i)
            got.append(logits)
    k = cache["l0_attn"]["k"]
    return {"gap": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "shape": tuple(a.shape for a in got) == tuple(b.shape
                                                          for b in ref),
            "headdim_decodes": registry().value(L.HEADDIM_TP_CALLS) - h0,
            "cache_k": tuple(k.shape)}


def _collectives(model, shape):
    """Collectives of one no-grad forward (loss) and of one attention and
    one MLP block on its own."""
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _masked_batch(model.cfg)
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    out = {}
    with SH.activation_sharding(axes, mesh), torch.no_grad():
        local = model.local_params(dparams)
        c0 = dict(SH.COLLECTIVES)
        model.loss(local, batch, remat=False)
        out["loss"] = {k: SH.COLLECTIVES[k] - c0[k] for k in c0}
        g0 = {k: v[0] for k, v in local["stack"]["l0_attn"].items()}
        x = torch.randn(2, 8, model.cfg.d_model,
                        generator=torch.Generator().manual_seed(2))
        blocks = {b.kind: b for b in model.blocks}
        c0 = dict(SH.COLLECTIVES)
        L.attn_apply(g0, blocks["attn"].spec, x,
                     positions=torch.arange(8))
        out["attn"] = {k: SH.COLLECTIVES[k] - c0[k] for k in c0}
        g0 = {k: v[0] for k, v in local["stack"]["l0_mlp"].items()}
        c0 = dict(SH.COLLECTIVES)
        L.mlp_apply(g0, blocks["mlp"].spec, x)
        out["mlp"] = {k: SH.COLLECTIVES[k] - c0[k] for k in c0}
        out["wq"] = tuple(local["stack"]["l0_attn"]["wq"].shape)
        out["wd"] = tuple(local["stack"]["l0_mlp"]["wd"].shape)
        out["embedding"] = tuple(local["embed"]["embedding"].shape)
    return out


def _tp_rank(rank, world):
    cfg = _cfg("internlm2-1.8b")
    model = build_model(cfg)
    out = {"train": {}, "serve": {}}
    for shape in TRAIN_MESHES[world]:
        out["train"][shape], _ = train_against_one_process(
            model, shape, _masked_batch(cfg))
    shape = (1, world)
    for arch in TRAIN_FAMILIES:
        fcfg = _cfg(arch)
        out["train"][(arch, shape)], _ = train_against_one_process(
            build_model(fcfg), shape, _masked_batch(fcfg))
    for arch in SERVE_ARCHS:
        out["serve"][(arch, shape)] = serve_against_one_process(arch, shape)
    if world == 2:
        out["collectives"] = _collectives(model, shape)
    return out


@pytest.fixture(scope="module")
def tp():
    res = {}
    for world in (2, 4):
        ranks = spawn(_tp_rank, world, timeout=RANK_TIMEOUT)
        res[world] = ranks
    return res


def _train_cases():
    return [(w, s) for w, shapes in TRAIN_MESHES.items() for s in shapes]


@pytest.mark.parametrize("world,shape", _train_cases() + [
    (w, (arch, (1, w))) for arch in TRAIN_FAMILIES for w in (2, 4)],
    ids=str)
def test_split_train_step_matches_one_process(tp, world, shape):
    for r in tp[world]:
        t = r["train"][shape]
        for got, want in zip(t["split"], t["one"]):
            assert abs(got - want) <= 1e-4 * abs(want) + 1e-6, (got, want)
        assert t["excess"] <= 0.0, t["excess"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_split_prefill_and_decode_match_one_process(tp, world, arch):
    for r in tp[world]:
        s = r["serve"][(arch, (1, world))]
        assert s["shape"], s
        assert s["gap"] <= 1e-4, s
        if world == 4:     # 2 kv heads over 4 ranks: head_dim-split cache
            assert s["cache_k"][-2:] == (2, 8), s
            model = build_model(_cfg(arch))
            n_attn = model.n_groups * sum(
                b.kind in ("attn", "cross_attn") for b in model.blocks)
            assert s["headdim_decodes"] == STEPS * n_attn, s
        else:
            assert s["cache_k"][-2:] == (1, 32), s
            assert s["headdim_decodes"] == 0, s


def test_each_rank_holds_its_slices(tp):
    cfg = _cfg("internlm2-1.8b")
    for r in tp[2]:
        c = r["collectives"]
        # stacked: a leading [n_groups] dim
        assert c["wq"][1:] == (cfg.d_model, cfg.n_heads // 2, cfg.head_dim)
        assert c["wd"][1:] == (cfg.d_ff // 2, cfg.d_model)
        assert c["embedding"][0] == build_model(cfg).vocab_padded // 2


def test_one_all_reduce_after_attention_and_after_the_mlp(tp):
    n_layers = _cfg("internlm2-1.8b").n_layers
    for r in tp[2]:
        c = r["collectives"]
        assert c["attn"] == {"all_reduce": 1, "all_gather": 0,
                             "reduce_scatter": 0, "all_to_all": 0}, c
        assert c["mlp"] == {"all_reduce": 1, "all_gather": 0,
                            "reduce_scatter": 0, "all_to_all": 0}, c
        # embedding lookup + 2 a block + the CE's max, Σexp, target logit
        assert c["loss"] == {"all_reduce": 1 + 2 * n_layers + 3,
                             "all_gather": 0, "reduce_scatter": 0,
                             "all_to_all": 0}, c


def test_constrain_resolves_as_the_reference():
    """``constrain`` keeps the reference's resolution: an axis of size 1,
    one already used, or one that does not divide the dim leaves it
    unsharded; outside a context nothing is sharded; no data moves."""
    axes = SH.MeshAxes(dp=("data",), fsdp=None, tp="model", ep="model",
                       sp=None, sizes={"data": 2, "model": 4})
    assert SH.constrain((4, 8, 12), ("dp", None, "tp")) == (None,) * 3
    x = torch.zeros(4, 8, 12)
    with SH.activation_sharding(axes):
        assert SH.constrain(x, ("dp", None, "tp")) == ("data", None, "model")
        assert SH.constrain((3, 8, 6), ("dp", None, "tp")) == (None,) * 3
        assert SH.constrain((4, 8), ("tp", "ep")) == ("model", None)
        assert SH.constrain((4, 8), ("sp", "tp")) == (None, "model")
    one = SH.MeshAxes(dp=("data",), fsdp=None, tp="model", ep="model",
                      sp=None, sizes={"data": 1, "model": 1})
    with SH.activation_sharding(one):
        assert SH.constrain(x, ("dp", None, "tp")) == (None,) * 3
