"""The context-parallel decode: a serving batch that the data axes do not
divide (batch 1 here, as ``long_500k``'s) is replicated on every data
rank and the KV cache split over ``kvseq``; each rank attends over its
slice of the slots and the ranks merge (``specs.merge_attention``).

Gloo CPU ranks (``launch.mesh.spawn``), f32, reduced configs, meshes
(data 2, model 1), (data 4, model 1) and (data 2, model 2) (the last
splits gemma3's kv heads over the model axis and the cache over
``kvseq`` at once), against the port's one-process decode from the same
params and cache:

  * reduced gemma3-12b (6 layers, 5 windowed at window 8, 1 global),
    jamba-v0.1-52b (attention beside Mamba) and xlstm-125m (no attention:
    its states stay whole on every data rank): the logits of split
    ``decode_step``s within 1e-5, at a position in the first slice
    (every other slice empty), at both sides of a slice boundary, with
    the window straddling two slices, and at the last slot;
  * ``Model.prefill`` of a batch-1 prompt, then greedy decode across a
    slice boundary: the one-process tokens exactly;
  * reduced seamless-m4t-medium, whose cross-attention memory is split
    over ``kvseq`` too: its prefill and decode logits within 1e-5;
  * the JAX package's jitted ``decode_step``, its cache placed by the
    reference's ``cache_dims``/``param_specs`` on a 2-device host mesh,
    against the port's split logits on (data 2, model 1) within 1e-4;
  * reduced gemma3-12b at 33 slots, which no data axis divides: the
    cache stays whole and decodes with no merge; then, on the same
    model, a split cache of 33 slots a data rank, and seamless's whole
    33-slot memory beside such a split cache: each read by the global
    slot count its tensors carry, one process's logits within 1e-5;
  * ``kvseq_slice`` follows ``leaf_spec``'s layout over ``("pod",
    "data")``, the merge's two all-reduces a global layer, and a merge
    whose every slice is empty gives 0, not NaN.

Each spawned run has its own time limit.
"""
import dataclasses
import math
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import state_from_jax
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.sharding import specs as SH

RANK_TIMEOUT = 240
AXES = ("data", "model")
ARCHS = ("gemma3-12b", "jamba-v0.1-52b", "xlstm-125m")
MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}
T_CACHE = 32          # slots: 16 a data rank on 2, 8 on 4
T_ODD = 33            # slots no data axis divides: the cache stays whole
PROMPT = 12
GREEDY = 8            # decode from PROMPT across the boundary at 16


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def positions(n_data):
    """A position in the first slice, both sides of a boundary, the window
    (8) straddling it, and the last slot."""
    b = T_CACHE // n_data
    return [3, b - 1, b, b + 3, T_CACHE - 1]


def _distribute(specs, tree, mesh):
    return SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, tree)


def _filled_cache(model, params, seed, slots=T_CACHE):
    """A batch-1 cache of ``slots`` slots: the states of a short prompt's
    prefill, every attention slot drawn from a seeded generator (zeros
    would hide a wrong merge)."""
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 4), generator=gen,
                           dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": prompt}, cache_len=slots)
    for blk in model.blocks:
        if blk.kind == "attn":
            for kk in ("k", "v"):
                t = cache[blk.name][kk]
                t.copy_(torch.randn(t.shape, generator=gen))
    return cache


def _clone(cache):
    return {b: {kk: t.clone() for kk, t in c.items()}
            for b, c in cache.items()}


def decode_against_one_process(arch, shape, slots=T_CACHE, at=None):
    """The split decode at ``at`` (default ``positions``) against one
    process: the largest logit gap a step, the local cache shapes, and
    the all-reduces of one step."""
    model = build_model(_cfg(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cache = _filled_cache(model, params, seed=1, slots=slots)
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    dparams = _distribute(SH.param_specs(model.param_dims(), params, axes),
                          params, mesh)
    dcache = _distribute(model.cache_specs(cache, axes), cache, mesh)
    one = _clone(cache)
    toks = torch.randint(0, model.cfg.vocab_size, (8, 1, 1),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    gaps, reduces = [], []
    for i, pos in enumerate(at or positions(shape[0])):
        want, one = model.decode_step(params, one, toks[i], pos)
        c0 = SH.COLLECTIVES["all_reduce"]
        with SH.activation_sharding(axes, mesh):
            got, dcache = model.decode_step(dparams, dcache, toks[i], pos)
        reduces.append(SH.COLLECTIVES["all_reduce"] - c0)
        gaps.append(float((got - want).abs().max()))
    return {"gaps": gaps, "all_reduces": reduces,
            "shapes": {f"{b}/{kk}": tuple(t.shape)
                       for b, c in dcache.items() for kk, t in c.items()}}


def greedy_against_one_process(arch, shape, slots=T_CACHE, model=None):
    """Prefill of a batch-1 prompt, then GREEDY greedy tokens, in one
    process and split: both token lists, and the largest logit gap.
    ``model`` (default: a new one of ``arch``) may have served before."""
    model = model or build_model(_cfg(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, model.cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    dparams = _distribute(SH.param_specs(model.param_dims(), params, axes),
                          params, mesh)

    def run(p, ctx):
        with ctx:
            logits, cache = model.prefill(p, {"tokens": prompt},
                                          cache_len=slots)
            out, seen = [], [logits]
            for i in range(GREEDY):
                out.append(int(logits.argmax(-1)))
                logits, cache = model.decode_step(
                    p, cache, torch.tensor([[out[-1]]], dtype=torch.int32),
                    PROMPT + i)
                seen.append(logits)
        return out, seen

    import contextlib
    one, want = run(params, contextlib.nullcontext())
    split, got = run(dparams, SH.activation_sharding(axes, mesh))
    return {"one": one, "split": split,
            "gap": max(float((a - b).abs().max()) for a, b in zip(got, want))}


def cross_against_one_process(shape, frontend_len=None, slots=T_CACHE):
    """Reduced seamless-m4t-medium, batch 1: prefill (its 8-slot memory,
    or ``frontend_len`` slots, split over kvseq where the data ranks
    divide it) and three decode steps over a ``slots``-slot cache, the
    largest logit gap."""
    cfg = _cfg("seamless-m4t-medium")
    model = build_model(dataclasses.replace(
        cfg, frontend_len=frontend_len or cfg.frontend_len))
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT),
                                     generator=gen, dtype=torch.int32),
             "frames": torch.randn(1, cfg.frontend_len, cfg.d_model,
                                   generator=gen) * 0.02}
    mesh = make_test_mesh(shape, AXES, "cpu")
    axes = SH.make_axes(mesh)
    dparams = _distribute(SH.param_specs(model.param_dims(), params, axes),
                          params, mesh)
    ref, fed = [], []
    logits, cache = model.prefill(params, batch, cache_len=slots)
    ref.append(logits)
    for i in range(3):
        fed.append(logits.argmax(-1, keepdim=True).int())
        logits, cache = model.decode_step(params, cache, fed[-1], PROMPT + i)
        ref.append(logits)
    with SH.activation_sharding(axes, mesh):
        logits, dcache = model.prefill(dparams, batch, cache_len=slots)
        got = [logits]
        for i in range(3):
            logits, dcache = model.decode_step(dparams, dcache, fed[i],
                                               PROMPT + i)
            got.append(logits)
    return {"gap": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "mk": tuple(dcache["l0_xattn"]["mk"].shape),
            "k": tuple(dcache["l0_attn"]["k"].shape)}


def _slices_and_merge(world):
    """kvseq_slice on a (pod 2, data 2, model 1) mesh against the region
    ``leaf_spec``'s layout gives this rank (and its refusal of slots the
    data ranks do not divide), and merges of empty slices."""
    out = {}
    mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    axes = SH.make_axes(mesh)
    shape = (1, 1, 64, 2, 8)
    spec = SH.leaf_spec(("layers", "batch", "kvseq", "kv_heads",
                         "head_dim"), shape, axes)
    off, shp = SH.region_of(shape, mesh, SH.mesh_placements(spec, mesh))
    with SH.activation_sharding(axes, mesh), SH.serving_batch(1):
        out["spec"] = spec
        out["slice"] = SH.kvseq_slice(64)
        out["region"] = (off[2], off[2] + shp[2])
        out["split"] = (SH.kvseq_split(1), SH.kvseq_split(4),
                        SH.kvseq_split(2))
        out["undivided"] = SH.kvseq_slice(66)
        # a tensor of 66 slots marked whole, one of 16 a slice of 64, and
        # one of 66 local slots marked as a slice of 264
        out["ranges"] = (
            SH.kvseq_range(SH.kvseq_mark(torch.zeros(1, 66), 66)),
            SH.kvseq_range(torch.zeros(1, 16)),
            SH.kvseq_range(SH.kvseq_mark(torch.zeros(1, 66), 264)))
        o = torch.ones(1, 1, 2, 8)
        lse = torch.full((1, 1, 2), -math.inf)
        out["empty"] = SH.merge_attention(o * 0, lse).numpy()
        # rank r holds score r on each head: the merge weights 1:e:e^2:e^3
        r = dist_rank()
        out["mixed"] = SH.merge_attention(torch.full((1, 1, 2, 8), float(r)),
                                          torch.full((1, 1, 2), float(r))
                                          ).numpy()
    return out


def dist_rank():
    import torch.distributed as dist
    return dist.get_rank()


def _cp_rank(rank, world):
    out = {"decode": {}, "greedy": {}, "cross": {}, "odd": {},
           "after_odd": {}, "odd_memory": {}}
    for shape in MESHES[world]:
        for arch in ARCHS:
            out["decode"][(arch, shape)] = decode_against_one_process(
                arch, shape)
            out["greedy"][(arch, shape)] = greedy_against_one_process(
                arch, shape)
        out["cross"][shape] = cross_against_one_process(shape)
        out["odd"][shape] = {
            "decode": decode_against_one_process(
                "gemma3-12b", shape, T_ODD, [3, 16, 17, T_ODD - 1]),
            "greedy": greedy_against_one_process("gemma3-12b", shape,
                                                 T_ODD)}
        # one model serves a whole cache of T_ODD slots, then a split one
        # of T_ODD local slots; an enc-dec model holds a whole memory of
        # T_ODD slots beside a split self-attention cache of T_ODD local
        model = build_model(_cfg("gemma3-12b"))
        greedy_against_one_process("gemma3-12b", shape, T_ODD, model)
        out["after_odd"][shape] = greedy_against_one_process(
            "gemma3-12b", shape, T_ODD * shape[0], model)
        out["odd_memory"][shape] = cross_against_one_process(
            shape, T_ODD, T_ODD * shape[0])
    if world == 4:
        out["slices"] = _slices_and_merge(world)
    return out


@pytest.fixture(scope="module")
def cp():
    return {world: spawn(_cp_rank, world, timeout=RANK_TIMEOUT)
            for world in (2, 4)}


def _cases():
    return [(w, s) for w, shapes in MESHES.items() for s in shapes]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_split_decode_matches_one_process(cp, world, shape, arch):
    for r in cp[world]:
        d = r["decode"][(arch, shape)]
        assert max(d["gaps"]) <= 1e-5, d["gaps"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_prefill_then_greedy_decode_gives_one_process_tokens(cp, world,
                                                             shape, arch):
    for r in cp[world]:
        g = r["greedy"][(arch, shape)]
        assert g["split"] == g["one"], g


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_split_cross_memory_matches_one_process(cp, world, shape):
    cfg = _cfg("seamless-m4t-medium")
    for r in cp[world]:
        c = r["cross"][shape]
        assert c["gap"] <= 1e-5, c
        kv = cfg.n_kv_heads // shape[1]
        assert c["mk"] == (cfg.n_layers, 1, cfg.frontend_len // shape[0], kv,
                           cfg.head_dim), c


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_caches_split_over_kvseq_and_states_stay_whole(cp, world, shape,
                                                       arch):
    """Each rank holds T/n slots of every attention cache, and every Mamba
    and xLSTM state whole over the data ranks (no kvseq dim), the Mamba
    ``h``/``conv`` and mLSTM ``conv`` channels split over the model axis,
    as leaf_spec lays them out for a batch of 1."""
    model = build_model(_cfg(arch))
    whole = model.init_cache(1, T_CACHE, "cpu")
    for r in cp[world]:
        shapes = r["decode"][(arch, shape)]["shapes"]
        assert len(shapes) == sum(len(c) for c in whole.values())
        for blk in model.blocks:
            for kk, t in whole.get(blk.name, {}).items():
                want = list(t.shape)
                if blk.kind == "attn":
                    want[2] //= shape[0]
                    want[3] //= shape[1]
                elif (blk.kind, kk) == ("mamba", "h"):
                    want[2] //= shape[1]
                elif kk == "conv":
                    want[3] //= shape[1]
                assert shapes[f"{blk.name}/{kk}"] == tuple(want), (blk, kk)


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_a_cache_the_data_ranks_do_not_divide_decodes_whole(cp, world,
                                                            shape):
    """Reduced gemma3-12b at batch 1 over 33 slots, which no data axis
    divides: the cache stays whole on every data rank (as ``leaf_spec``
    keeps it), with no error, and the split decode from a distributed
    cache and a split prefill with greedy decode give one process's
    logits within 1e-5 and its tokens: each layer's attention is counted
    once, with no merge."""
    for r in cp[world]:
        d = r["odd"][shape]["decode"]
        assert max(d["gaps"]) <= 1e-5, d["gaps"]
        if shape[1] == 1:           # no head split: nothing to reduce
            assert d["all_reduces"] == [0] * 4, d["all_reduces"]
        ks = [v for k, v in d["shapes"].items() if k.endswith("/k")]
        assert ks and all(k[2] == T_ODD for k in ks), d["shapes"]
        g = r["odd"][shape]["greedy"]
        assert g["split"] == g["one"] and g["gap"] <= 1e-5, g


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_a_split_cache_after_a_whole_one_of_as_many_local_slots(cp, world,
                                                                shape):
    """A model that decoded a whole 33-slot cache then decodes a split
    one of 33 slots a data rank: read split, by the layout its tensors
    carry, and merged, so every rank gives one process's tokens and
    logits within 1e-5."""
    for r in cp[world]:
        g = r["after_odd"][shape]
        assert g["split"] == g["one"] and g["gap"] <= 1e-5, g


@pytest.mark.parametrize("world,shape", _cases(), ids=str)
def test_a_whole_memory_beside_a_split_cache_of_as_many_local_slots(
        cp, world, shape):
    """Reduced seamless-m4t-medium with a 33-slot encoder memory, which
    stays whole, beside a self-attention cache split into 33 slots a
    data rank: each read by its own layout, one process's logits within
    1e-5."""
    cfg = _cfg("seamless-m4t-medium")
    kv = cfg.n_kv_heads // shape[1]
    for r in cp[world]:
        c = r["odd_memory"][shape]
        assert c["gap"] <= 1e-5, c
        assert c["mk"][2] == c["k"][2] == T_ODD, c
        assert c["mk"][3] == kv, c


def test_merge_takes_two_all_reduces_a_global_layer(cp):
    """On (2, 1) gemma3's six attention layers (five windowed, one global)
    each merge with a MAX and a SUM all-reduce; nothing else is reduced."""
    model = build_model(_cfg("gemma3-12b"))
    n_attn = model.n_groups * sum(b.kind == "attn" for b in model.blocks)
    for r in cp[2]:
        assert r["decode"][("gemma3-12b", (2, 1))]["all_reduces"] == \
            [2 * n_attn] * len(positions(2))


def test_kvseq_slice_follows_the_leaf_spec_layout(cp):
    for rank, r in enumerate(cp[4]):
        s = r["slices"]
        assert s["spec"][2] == ("pod", "data"), s["spec"]
        assert s["slice"] == s["region"] == (16 * rank, 16 * rank + 16), s
        assert s["split"] == (True, False, True), s
        # the 4 data ranks do not divide 66 slots: kept whole, as
        # leaf_spec lays such a cache out, and read whole by the layout
        # its tensor carries, whatever its local slot count
        assert s["undivided"] == (0, 66), s
        assert s["ranges"] == (None, (16 * rank, 16 * rank + 16),
                               (66 * rank, 66 * rank + 66)), s


def test_merge_of_empty_slices_is_zero_not_nan(cp):
    for r in cp[4]:
        e = r["slices"]["empty"]
        assert not np.isnan(e).any() and (e == 0).all(), e


def test_merge_weights_each_rank_by_its_lse(cp):
    w = torch.exp(torch.arange(4.0))
    want = float((w * torch.arange(4.0)).sum() / w.sum())
    for r in cp[4]:
        m = r["slices"]["mixed"]
        assert np.allclose(m, want, atol=1e-6), m


def test_windowed_slice_outside_the_window_gives_minus_inf():
    """attention_ref over a slice of slots wholly outside the window (or
    past the token): zeros and -inf, no NaN; inside, its lse is the
    logsumexp of the visible scores."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(1, 1, 4, 8, generator=gen)
    k, v = torch.randn(2, 1, 16, 2, 8, generator=gen)
    pos = torch.tensor([40])
    for lo in (0, 48):            # before the window, past the token
        out, lse = L.attention_ref(q, k, v, causal=True, window=8,
                                   q_positions=pos,
                                   kv_positions=lo + torch.arange(16),
                                   return_lse=True)
        assert (out == 0).all() and torch.isinf(lse).all() and \
            (lse < 0).all()
    out, lse = L.attention_ref(q, k, v, causal=True, window=8,
                               q_positions=pos,
                               kv_positions=30 + torch.arange(16),
                               return_lse=True)
    qg = q.reshape(1, 1, 2, 2, 8)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(8)
    vis = (30 + torch.arange(16) <= 40) & (30 + torch.arange(16) > 32)
    want = torch.logsumexp(sc[..., vis], dim=-1)[..., 0].reshape(1, 1, 4)
    assert torch.allclose(lse, want, atol=1e-6), (lse, want)


_JAX_DECODE = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.sharding.specs import activation_sharding, make_axes, param_specs
cfg = dataclasses.replace(reduced(get_config("gemma3-12b")), dtype="float32")
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
rng = np.random.default_rng(7)
cache = jax.tree.map(lambda t: rng.standard_normal(t.shape).astype(
    np.float32), jax.device_get(model.init_cache(1, {T})))
toks = rng.integers(0, cfg.vocab_size, ({n}, 1, 1)).astype(np.int32)
with open({path!r}, "wb") as f:
    pickle.dump((jax.device_get(params), cache, toks), f)
mesh = make_test_mesh((2, 1), ("data", "model"))
axes = make_axes(mesh)
sh = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                is_leaf=lambda x: isinstance(x, P))
cache_sh = sh(param_specs(model.cache_dims(), cache, axes))
def serve_step(params, cache, token, pos):
    with activation_sharding(axes):
        return model.decode_step(params, cache, token, pos)
step = jax.jit(serve_step, out_shardings=(None, cache_sh))
p = jax.device_put(params, sh(param_specs(model.param_dims(), params, axes)))
c = jax.device_put(cache, cache_sh)
assert c["l0_attn"]["k"].sharding.spec[2] == "data", c["l0_attn"]["k"].sharding
out = []
with mesh:
    for i, pos in enumerate({positions}):
        logits, c = step(p, c, jnp.asarray(toks[i]), jnp.int32(pos))
        out.append(np.asarray(logits))
with open({path!r} + ".logits", "wb") as f:
    pickle.dump(out, f)
"""


def _jax_rank(rank, world, np_params, np_cache, toks):
    model = build_model(_cfg("gemma3-12b"))
    params = state_from_jax(np_params, "cpu")
    cache = state_from_jax(np_cache, "cpu")
    mesh = make_test_mesh((2, 1), AXES, "cpu")
    axes = SH.make_axes(mesh)
    dparams = _distribute(SH.param_specs(model.param_dims(), params, axes),
                          params, mesh)
    dcache = _distribute(model.cache_specs(cache, axes), cache, mesh)
    out = []
    with SH.activation_sharding(axes, mesh):
        for i, pos in enumerate(positions(2)):
            logits, dcache = model.decode_step(
                dparams, dcache, torch.from_numpy(toks[i]), pos)
            out.append(logits.numpy())
    return out


def test_split_decode_matches_the_reference_jitted_decode(tmp_path):
    from tests.conftest import run_subprocess
    path = os.path.join(str(tmp_path), "gemma3.pkl")
    run_subprocess(_JAX_DECODE.format(path=path, T=T_CACHE,
                                      n=len(positions(2)),
                                      positions=positions(2)),
                   devices=2, timeout=300)
    with open(path, "rb") as f:
        np_params, np_cache, toks = pickle.load(f)
    with open(path + ".logits", "rb") as f:
        want = pickle.load(f)
    ranks = spawn(_jax_rank, 2, np_params, np_cache, toks,
                  timeout=RANK_TIMEOUT)
    for got in ranks:
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert float(np.abs(g - w).max()) <= 1e-4
