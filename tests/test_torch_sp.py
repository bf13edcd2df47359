"""Sequence sharding of the residual stream between blocks (the port of
the reference's ``seq_shard``: ``make_axes(mesh, seq_shard=True)``), on
gloo CPU ranks (``launch.mesh.spawn``), f32, reduced configs, against
the port's one-process step and prefill from the same init:

  * the train step with ``seq_shard`` on meshes (data 1, model 2),
    (1, 4) and (2, 2) for internlm2-1.8b, gemma3-12b (windowed layers),
    llama4-scout-17b-a16e (MoE over ``ep``, run whole on each rank's
    gathered rows), seamless-m4t-medium (the split encoder and the
    cross-attention memory), internvl2-2b (patch embeddings, the stream
    cut after the concat; and a batch of 23 tokens, whose 31 positions
    do not divide, so the stream stays whole) and jamba-v0.1-52b (an
    explicit ``seq_shard=True``: its Mamba and MoE blocks run whole):
    the loss, every gradient (AdamW's first moment with clipping off,
    m = (1 - b1) g) and every update within rtol 1e-4 / atol 1e-6 of
    one process's, and of the same mesh with ``seq_shard`` off (an
    update where one process's |g| >= 1e-6: AdamW's first step takes
    g / (|g| + 1e-8), so an f32 sum in another order moves the update of
    a gradient near 1e-8 by more than 1e-6, with ``seq_shard`` off as
    much as on). The MoE archs' gradients (llama4-scout, jamba) are also
    allowed 1e-5 of their leaf's largest entry, as the model-axis split's
    own tests allow them (``tests/test_torch_tp_moe.py``,
    ``tests/test_torch_tp_ssm.py``): the embedding's rows sum many
    tokens' parts, in another order than one process;
  * each model rank holds S / tp rows of the stream between blocks;
  * the norm weights' gradients, which ``copy_to_tp`` sums over the
    model ranks (each rank norms a part of the rows), on their own;
  * internlm2 against the JAX package's jitted step with
    ``make_axes(mesh, seq_shard=True)`` on a 2-device host mesh, from the
    same init and batch: loss within 1e-4, first moments within 1e-4 of
    the entry plus 1e-4 of the leaf's largest entry;
  * sharded prefill with ``seq_shard`` on (1, 2), (1, 4) and (2, 2):
    last-position logits, two decode steps after it and every cache leaf
    (this rank's slice of one process's) within 1e-4;
  * the collectives of one forward, by kind: an attention and an MLP
    block each one all-gather and one reduce-scatter and no all-reduce;
    the loss's embedding one reduce-scatter, its unembedding one
    all-gather, and the CE's three all-reduces.

Each spawned run has its own time limit.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import state_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.sharding import specs as SH
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_state, make_train_step,
                                       shard_state)
from repro_torch.tree import leaves_with_path, tree_leaves

RANK_TIMEOUT = 300
AXES = ("data", "model")
OPT = AdamWConfig(warmup_steps=1, total_steps=8, grad_clip=0.0)
B1 = OPT.b1
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
# "internvl2-2b/odd": 23 tokens after 8 patch embeddings, 31 positions
TRAIN_ARCHS = ("internlm2-1.8b", "gemma3-12b", "llama4-scout-17b-a16e",
               "seamless-m4t-medium", "internvl2-2b", "internvl2-2b/odd",
               "jamba-v0.1-52b")
SERVE_ARCHS = ("internlm2-1.8b", "gemma3-12b", "llama4-scout-17b-a16e",
               "seamless-m4t-medium", "internvl2-2b", "jamba-v0.1-52b")
PROMPT, STEPS = 16, 2
# the least |gradient| at which an update is held to one process's
G_FLOOR = 1e-6
# gradients are also allowed this much of their leaf's largest entry
LEAF_RTOL = {"llama4-scout-17b-a16e": 1e-5, "jamba-v0.1-52b": 1e-5}


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch.split("/")[0])),
                               dtype="float32")


def _batch(arch):
    cfg = _cfg(arch)
    b = TokenPipeline(cfg, 4, 32, seed=0).next("cpu")
    if arch.endswith("/odd"):
        b["tokens"], b["targets"] = b["tokens"][:, 1:], b["targets"][:, 1:]
    b["targets"] = b["targets"].clone()
    b["targets"][:2, 4:] = -1
    return b


def _gap(got, want, leaf_rtol=0.0):
    """The largest excess of |got - want| over 1e-6 + 1e-4 |want| +
    ``leaf_rtol`` max |want| (<= 0: within; -1 for no entries)."""
    if want.numel() == 0:
        return -1.0
    return float((got - want).abs().sub(
        1e-6 + 1e-4 * want.abs() + leaf_rtol * want.abs().max()).max())


def _excess(got, want, scale=1.0, leaf_rtol=0.0):
    """The largest excess, leaf by leaf (by path), of |got - want| over
    1e-6 + 1e-4 |want| + ``leaf_rtol`` max |want|, both divided by
    ``scale`` (<= 0: within)."""
    def one(a, b):
        b = b / scale
        return float(((SH.full_tensor(a) / scale - b).abs()
                      - (1e-6 + 1e-4 * b.abs() + leaf_rtol * b.abs().max()))
                     .max())
    return {"/".join(path): one(a, b) for (path, a), b in zip(
        leaves_with_path(got), tree_leaves(want))}


def _train(arch, shape):
    """One step in one process and on the mesh with ``seq_shard`` on and
    off: losses, the excess of the gradients and of the updates over
    one process's, leaf by leaf, that of the ``seq_shard`` step over the
    step with it off, and the collectives by kind. An update is held
    where one process's gradient is at least ``G_FLOOR``: AdamW's first
    step divides g by |g| + 1e-8, so below that the gradient's own atol
    admits any update."""
    model = build_model(_cfg(arch))
    state = init_state(model, 0, "cpu")
    batch = _batch(arch)
    one, m1 = make_train_step(model, OPT)(state, batch)
    paths = ["/".join(k) for k, _ in leaves_with_path(state["params"])]
    held = [(m / (1 - B1)).abs() >= G_FLOOR
            for m in tree_leaves(one["opt_state"]["m"])]
    want = [a - b for a, b in zip(tree_leaves(one["params"]),
                                  tree_leaves(state["params"]))]
    mesh = make_test_mesh(shape, AXES, "cpu")
    out = {"one": float(m1["loss"])}
    got = {}
    for on in (True, False):
        axes = SH.make_axes(mesh, seq_shard=on)
        st = shard_state(model, state, mesh, axes)
        c0 = dict(SH.COLLECTIVES)
        new, m2 = make_train_step(model, OPT, mesh=mesh, axes=axes)(
            st, batch)
        got[on] = ([SH.full_tensor(a) - SH.full_tensor(b) for a, b in zip(
                    tree_leaves(new["params"]), tree_leaves(st["params"]))],
                   [SH.full_tensor(m) / (1 - B1)
                    for m in tree_leaves(new["opt_state"]["m"])])
        out[on] = {
            "loss": float(m2["loss"]),
            "grads": _excess(new["opt_state"]["m"], one["opt_state"]["m"],
                             1 - B1, LEAF_RTOL.get(arch, 0.0)),
            "updates": {k: _gap(u[h], w[h]) for k, u, w, h in zip(
                paths, got[on][0], want, held)},
            "coll": {k: SH.COLLECTIVES[k] - c0[k] for k in c0}}
    out["on_vs_off"] = {
        "grads": max(_gap(a, b, LEAF_RTOL.get(arch, 0.0))
                     for a, b in zip(got[True][1], got[False][1])),
        "updates": max(_gap(a[h], b[h]) for a, b, h in zip(
            got[True][0], got[False][0], held))}
    return out


def _local(whole, spec, mesh):
    off, shp = SH.region_of(whole.shape, mesh,
                            SH.mesh_placements(spec, mesh))
    return whole[tuple(slice(o, o + s) for o, s in zip(off, shp))]


def _serve(arch, shape):
    """Prefill and STEPS greedy decode steps in one process and on the
    mesh with ``seq_shard`` on, params as DTensors: the largest logit gap,
    the largest gap of a cache leaf to this rank's slice of one
    process's, and the reduce-scatters the prefill issued."""
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
    start = PROMPT + (cfg.frontend_len if cfg.family == "vlm" else 0)
    logits, cache = model.prefill(params, batch, cache_len=start + STEPS)
    one_cache = {b: {k: t.clone() for k, t in c.items()}
                 for b, c in cache.items()}
    ref, fed = [logits], []
    for i in range(STEPS):
        fed.append(logits.argmax(-1, keepdim=True).int())
        logits, cache = model.decode_step(params, cache, fed[-1], start + i)
        ref.append(logits)
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh, seq_shard=True)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    with SH.activation_sharding(axes, mesh):
        rs = SH.COLLECTIVES["reduce_scatter"]
        logits, cache = model.prefill(dparams, batch,
                                      cache_len=start + STEPS)
        rs = SH.COLLECTIVES["reduce_scatter"] - rs
        gaps = []
        SH.map_dims(lambda sp, whole, local: gaps.append(float(
            (_local(whole, sp, mesh) - local).abs().max())),
            model.cache_specs(one_cache, axes), one_cache, cache)
        got = [logits]
        for i in range(STEPS):
            logits, cache = model.decode_step(dparams, cache, fed[i],
                                              start + i)
            got.append(logits)
    return {"gap": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "cache_gap": max(gaps), "reduce_scatters": rs}


def _rows_and_collectives(shape):
    """internlm2 under ``seq_shard`` on: the rows of the stream each
    attention and MLP block is handed in a loss forward, and the
    collectives by kind of that forward (no grad) and of one attention
    and one MLP block on a rank's rows."""
    model = build_model(_cfg("internlm2-1.8b"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch("internlm2-1.8b")
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh, seq_shard=True)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    rows, out = [], {}
    saved = L.attn_apply, L.mlp_apply

    def seen(fn):
        def wrapped(p, spec, x, **kw):
            rows.append(x.shape[1])
            return fn(p, spec, x, **kw)
        return wrapped

    with SH.activation_sharding(axes, mesh), torch.no_grad():
        local = model.local_params(dparams)
        L.attn_apply, L.mlp_apply = seen(saved[0]), seen(saved[1])
        try:
            c0 = dict(SH.COLLECTIVES)
            model.loss(local, batch, remat=False)
            out["loss"] = {k: SH.COLLECTIVES[k] - c0[k] for k in c0}
        finally:
            L.attn_apply, L.mlp_apply = saved
        blocks = {b.kind: b for b in model.blocks}
        x = torch.randn(2, 8 // shape[1], model.cfg.d_model,
                        generator=torch.Generator().manual_seed(2))
        for kind, fn, kw in (("attn", L.attn_apply,
                              {"positions": torch.arange(8)}),
                             ("mlp", L.mlp_apply, {})):
            g0 = {k: v[0] for k, v in local["stack"][f"l0_{kind}"].items()}
            c0 = dict(SH.COLLECTIVES)
            y = fn(g0, blocks[kind].spec, x, sp=True, **kw)
            out[kind] = {k: SH.COLLECTIVES[k] - c0[k] for k in c0}
            out[kind + "_rows"] = y.shape[1]
    out["rows"] = rows
    return out


def _sp_rank(rank, world):
    out = {"train": {}, "serve": {}}
    for shape in MESHES[world]:
        for arch in TRAIN_ARCHS:
            out["train"][(arch, shape)] = _train(arch, shape)
        for arch in SERVE_ARCHS:
            out["serve"][(arch, shape)] = _serve(arch, shape)
        out["rows", shape] = _rows_and_collectives(shape)
    return out


@pytest.fixture(scope="module")
def sp():
    return {world: spawn(_sp_rank, world, timeout=RANK_TIMEOUT)
            for world in (2, 4)}


def _cases():
    return [(w, s) for w, shapes in MESHES.items() for s in shapes]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_seq_shard_train_step_matches_one_process(sp, world, shape, arch):
    for r in sp[world]:
        t = r["train"][(arch, shape)]
        for on in (True, False):
            got, want = t[on]["loss"], t["one"]
            assert abs(got - want) <= 1e-4 * abs(want) + 1e-6, (on, t)
            worst = max(t[on]["grads"].items(), key=lambda kv: kv[1])
            assert worst[1] <= 0.0, (on, worst)
            worst = max(t[on]["updates"].items(), key=lambda kv: kv[1])
            assert worst[1] <= 0.0, (on, worst)
        assert max(t["on_vs_off"].values()) <= 0.0, t["on_vs_off"]
        assert t[False]["coll"]["reduce_scatter"] == 0, t[False]["coll"]
        # a stream whose positions do not divide stays whole
        split = not arch.endswith("/odd")
        assert (t[True]["coll"]["reduce_scatter"] > 0) == split, t[True]
        if not split:
            assert t[True]["coll"] == t[False]["coll"], t


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_seq_shard_sums_the_norm_weights_gradients(sp, world, shape):
    """Each rank norms only its rows, so a norm weight's gradient is
    whole only once ``copy_to_tp`` has summed it over the model ranks."""
    for r in sp[world]:
        for arch in TRAIN_ARCHS:
            g = r["train"][(arch, shape)][True]["grads"]
            norms = {k: v for k, v in g.items()
                     if k.rsplit("/", 1)[-1] in ("norm", "final_norm")}
            assert len(norms) >= 3, sorted(g)
            worst = max(norms.items(), key=lambda kv: kv[1])
            assert worst[1] <= 0.0, (arch, worst)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_seq_shard_prefill_matches_one_process(sp, world, shape, arch):
    for r in sp[world]:
        s = r["serve"][(arch, shape)]
        assert s["gap"] <= 1e-4, s
        assert s["cache_gap"] <= 1e-4, s
        assert s["reduce_scatters"] > 0, s


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_each_model_rank_holds_its_rows_of_the_stream(sp, world, shape):
    cfg = _cfg("internlm2-1.8b")
    for r in sp[world]:
        rows = r["rows", shape]["rows"]
        assert rows == [32 // shape[1]] * (2 * cfg.n_layers), rows
        assert r["rows", shape]["attn_rows"] == 8 // shape[1]


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_seq_shard_forward_collectives_by_kind(sp, world, shape):
    n_layers = _cfg("internlm2-1.8b").n_layers
    for r in sp[world]:
        c = r["rows", shape]
        block = {"all_reduce": 0, "all_gather": 1, "reduce_scatter": 1,
                 "all_to_all": 0}
        assert c["attn"] == block and c["mlp"] == block, c
        # the embedding's reduce-scatter, one gather and one
        # reduce-scatter a block, the unembedding's gather, the CE's max,
        # Σexp and target logit (and its count of targets over the data
        # ranks)
        assert c["loss"] == {"all_reduce": 3 + (shape[0] > 1),
                             "all_gather": 2 * n_layers + 1,
                             "reduce_scatter": 2 * n_layers + 1,
                             "all_to_all": 0}, c


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
cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                          dtype="float32")
model = build_model(cfg)
state = init_state(model, jax.random.PRNGKey(0))
batch = {{k: np.array(v) for k, v in TokenPipeline(cfg, 4, 32,
                                                     seed=0).next().items()}}
batch["targets"][:2, 4:] = -1
mesh = make_test_mesh((1, 2), ("data", "model"))
axes = make_axes(mesh, seq_shard=True)
assert axes.sp == "model"
specs = param_specs(state_dims(model), state, axes)
sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                  is_leaf=lambda x: isinstance(x, P))
step = jax.jit(make_train_step(model, AdamWConfig(
    warmup_steps=1, total_steps=8, grad_clip=0.0), axes=axes))
with mesh:
    new, m = step(jax.device_put(state, sh),
                  {{k: jnp.asarray(v) for k, v in batch.items()}})
with open({path!r}, "wb") as f:
    pickle.dump((jax.device_get(state), batch,
                 jax.device_get(new["opt_state"]["m"]), float(m["loss"])), f)
"""


def _jax_rank(rank, world, np_state, np_batch, np_m):
    model = build_model(_cfg("internlm2-1.8b"))
    state = state_from_jax(np_state, "cpu")
    jax_m = state_from_jax(np_m, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    mesh = make_test_mesh((1, 2), AXES, "cpu")
    axes = SH.make_axes(mesh, seq_shard=True)
    new, m = make_train_step(model, OPT, mesh=mesh, axes=axes)(
        shard_state(model, state, mesh, axes), batch)
    excess = max(float(((SH.full_tensor(a) - b).abs()
                        - 1e-4 * (b.abs() + b.abs().max())).max())
                 for a, b in zip(tree_leaves(new["opt_state"]["m"]),
                                 tree_leaves(jax_m)))
    return {"loss": float(m["loss"]), "excess": excess,
            "reduce_scatters": SH.COLLECTIVES["reduce_scatter"]}


def test_seq_shard_matches_the_reference_jitted_step(tmp_path):
    from tests.conftest import run_subprocess
    path = os.path.join(str(tmp_path), "ref.pkl")
    run_subprocess(_JAX_STEP.format(path=path), devices=2, timeout=300)
    with open(path, "rb") as f:
        np_state, np_batch, np_m, jax_loss = pickle.load(f)
    ranks = spawn(_jax_rank, 2, np_state, np_batch, np_m,
                  timeout=RANK_TIMEOUT)
    for r in ranks:
        assert abs(r["loss"] - jax_loss) <= 1e-4, (r, jax_loss)
        assert r["excess"] <= 0.0, r
        assert r["reduce_scatters"] > 0, r
    assert np.isfinite(jax_loss)
