"""The q-head head_dim split: q heads that the model axis does not divide
(llama4's 40 over 16 ranks), on gloo CPU ranks (``launch.mesh.spawn``),
f32, reduced llama4-scout-17b-a16e with 6 q heads over 2 kv heads (head
dim 32) on mesh (data 1, model 4): 6 heads do not split over 4 ranks and
head dim 32 does, so ``leaf_spec`` splits ``wq`` and ``wo`` over
head_dim, and every attention layer runs ``layers.headdim_attention``
(partial q.k scores all-reduced, an f32 softmax over whole heads, p.v on
the rank's slice). Against one process from the same init and batch:

  * the split train step's loss within rtol 1e-5 and every gradient
    within 1e-5 of the entry plus 1e-5 of its leaf's largest entry (read
    from AdamW's first moment, clipping off: m = (1 - b1) g), also with
    the scores formed one query row at a time (``HEADDIM_CHUNK``);
  * prefill logits and three greedy decode steps within 1e-5, the KV
    caches split over head_dim, each decode of each attention layer
    through ``headdim_attention``;
  * the JAX package on a 4-device host mesh, from the same init, batch
    and tokens: its jitted step's loss within 1e-4 and its first moments
    within 1e-4 of the entry plus 1e-4 of the leaf's largest entry; its
    jitted prefill's logits and three decode steps' (each fed the token
    the JAX logits pick) within 1e-4;
  * with head dim 30, which 4 does not divide either, ``wq`` stays whole
    and every attention layer runs whole on every rank: the same
    comparisons hold and ``headdim_attention`` is not called.

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
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.obs.telemetry import registry
from repro_torch.sharding import specs as SH
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_state, make_train_step,
                                       shard_state)
from repro_torch.tree import tree_leaves

RANK_TIMEOUT = 240
OPT = AdamWConfig(warmup_steps=1, total_steps=8, grad_clip=0.0)
MESH = (1, 4)
STEPS = 3
PROMPT = 16


def _cfg(head_dim=32):
    return dataclasses.replace(reduced(get_config("llama4-scout-17b-a16e")),
                               dtype="float32", n_heads=6, head_dim=head_dim)


def _excess(got, want, tol):
    """The largest excess, over the leaves, of |got - want| over tol of
    the entry plus tol of the leaf's largest entry (<= 0: within)."""
    return max(float(((SH.full_tensor(a) - b).abs()
                      - tol * (b.abs() + b.abs().max())).max())
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _train(model, state, batch, mesh, axes, jax_m=None):
    """One step in one process and on the mesh: losses, the largest
    excess of the split first moments over 1e-5 (of one process's) and
    over 1e-4 (of the JAX step's, where given), and the head_dim
    attention calls."""
    one, m1 = make_train_step(model, OPT)(state, batch)
    c0 = registry().value(L.HEADDIM_TP_CALLS)
    st, m2 = make_train_step(model, OPT, mesh=mesh, axes=axes)(
        shard_state(model, state, mesh, axes), batch)
    out = {"one": float(m1["loss"]), "split": float(m2["loss"]),
           "excess": _excess(st["opt_state"]["m"], one["opt_state"]["m"],
                             1e-5),
           "calls": registry().value(L.HEADDIM_TP_CALLS) - c0}
    if jax_m is not None:
        out["excess_jax"] = _excess(st["opt_state"]["m"], jax_m, 1e-4)
    return out


def _serve(model, params, mesh, axes, tokens, fed):
    """Prefill of ``tokens`` and STEPS decode steps, step i fed
    ``fed[i]``, in one process and split: the largest logit gap, the
    split logits, the cache's local shape, and the head_dim calls in all
    and within the decode steps."""
    batch = {"tokens": tokens}
    logits, cache = model.prefill(params, batch, cache_len=PROMPT + STEPS)
    ref = [logits]
    for i in range(STEPS):
        logits, cache = model.decode_step(params, cache, fed[i], PROMPT + i)
        ref.append(logits)
    specs = SH.param_specs(model.param_dims(), params, axes)
    dparams = SH.map_dims(lambda sp, t: SH.distribute(
        t, mesh, SH.mesh_placements(sp, mesh)), specs, params)
    c0 = registry().value(L.HEADDIM_TP_CALLS)
    with SH.activation_sharding(axes, mesh):
        logits, cache = model.prefill(dparams, batch,
                                      cache_len=PROMPT + STEPS)
        got = [logits]
        d0 = registry().value(L.HEADDIM_TP_CALLS)
        for i in range(STEPS):
            logits, cache = model.decode_step(dparams, cache, fed[i],
                                              PROMPT + i)
            got.append(logits)
    return {"gap": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "rel": max(float((a.float() - b.float()).norm()
                             / b.float().norm()) for a, b in zip(got, ref)),
            "logits": [g.float().numpy() for g in got],
            "cache_k": tuple(cache["l0_attn"]["k"].shape),
            "wq": tuple(dparams["stack"]["l0_attn"]["wq"].to_local().shape),
            "decodes": registry().value(L.HEADDIM_TP_CALLS) - d0,
            "calls": registry().value(L.HEADDIM_TP_CALLS) - c0}


def _rank(rank, world, ref):
    model = build_model(_cfg())
    state = state_from_jax(ref["state"], "cpu")
    jax_m = state_from_jax(ref["m"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    tokens = torch.from_numpy(ref["tokens"])
    fed = [torch.from_numpy(f) for f in ref["fed"]]
    mesh = make_test_mesh(MESH, ("data", "model"), "cpu")
    axes = SH.make_axes(mesh)
    out = {"train": _train(model, state, batch, mesh, axes, jax_m)}
    chunk = L.HEADDIM_CHUNK
    L.HEADDIM_CHUNK = 1          # one query row a chunk
    try:
        out["train_rows"] = _train(model, state, batch, mesh, axes)
    finally:
        L.HEADDIM_CHUNK = chunk
    out["serve"] = _serve(model, state["params"], mesh, axes, tokens, fed)
    whole = build_model(_cfg(head_dim=30))
    state = init_state(whole, 0, "cpu")
    out["whole"] = _train(whole, state, batch, mesh, axes)
    out["serve_whole"] = _serve(whole, state["params"], mesh, axes, tokens,
                                fed)
    out["bf16"] = _bf16(batch, mesh, axes, tokens, fed)
    return out


_SCORE_SITES = ("models.layers._masked_scores", "models.layers.backward")


def _bf16(batch, mesh, axes, tokens, fed):
    """The split in bf16: a train step's score all-reduces from the
    collective log (forward, recompute and backward's d(p)), as (dtype,
    bytes, elements) each, and prefill and decode logits against one
    process's (``attention_ref`` in bf16)."""
    model = build_model(dataclasses.replace(_cfg(), dtype="bfloat16"))
    state = init_state(model, 0, "cpu")
    with SH.collective_log() as log:
        make_train_step(model, OPT, mesh=mesh, axes=axes)(
            shard_state(model, state, mesh, axes), batch)
    n = {"bfloat16": 2, "float32": 4}
    return {"scores": [(r["dtype"], r["bytes"], r["bytes"] // n[r["dtype"]])
                       for r in log
                       if r["site"].split("/")[0] in _SCORE_SITES],
            "serve": _serve(model, state["params"], mesh, axes, tokens, fed)}


_JAX_STEP = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.sharding.specs import activation_sharding, make_axes, param_specs
from repro.train import AdamWConfig, init_state, make_train_step
from repro.train.trainer import state_dims
cfg = dataclasses.replace(reduced(get_config("llama4-scout-17b-a16e")),
                          dtype="float32", n_heads=6)
model = build_model(cfg)
state = init_state(model, jax.random.PRNGKey(0))
batch = {{k: np.array(v) for k, v in TokenPipeline(cfg, 4, 32,
                                                     seed=0).next().items()}}
tokens = np.random.default_rng(1).integers(
    0, cfg.vocab_size, (4, {prompt}), dtype=np.int32)
ref = {{"state": jax.device_get(state), "batch": batch, "tokens": tokens}}
mesh = make_test_mesh((1, 4), ("data", "model"))
axes = make_axes(mesh)
specs = param_specs(state_dims(model), state, axes)
assert specs["params"]["stack"]["l0_attn"]["wq"] == P(None, None, None,
                                                      "model"), specs
sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                  is_leaf=lambda x: isinstance(x, P))
step = jax.jit(make_train_step(model, AdamWConfig(
    warmup_steps=1, total_steps=8, grad_clip=0.0), axes=axes))
with mesh:
    new, m = step(jax.device_put(state, sh),
                  {{k: jnp.asarray(v) for k, v in batch.items()}})
ref["m"] = jax.device_get(new["opt_state"]["m"])
print("LOSS", repr(float(m["loss"])))


def prefill(params, batch):
    with activation_sharding(axes):
        return model.prefill(params, batch, cache_len={prompt} + {steps})


def decode(params, cache, token, pos):
    with activation_sharding(axes):
        return model.decode_step(params, cache, token, pos)


prefill, decode = jax.jit(prefill), jax.jit(decode)
with mesh:
    params = jax.device_put(state["params"], sh["params"])
    logits, cache = prefill(params, {{"tokens": jnp.asarray(tokens)}})
    ref["logits"], ref["fed"] = [np.asarray(logits)], []
    for i in range({steps}):
        ref["fed"].append(np.asarray(jnp.argmax(logits, -1)[:, None],
                                     dtype=np.int32))
        logits, cache = decode(params, cache, jnp.asarray(ref["fed"][-1]),
                               jnp.int32({prompt} + i))
        ref["logits"].append(np.asarray(logits))
with open({path!r}, "wb") as f:
    pickle.dump(ref, f)
"""


@pytest.fixture(scope="module")
def hd(tmp_path_factory):
    from tests.conftest import run_subprocess
    path = os.path.join(str(tmp_path_factory.mktemp("hd")), "init.pkl")
    out = run_subprocess(_JAX_STEP.format(path=path, prompt=PROMPT,
                                          steps=STEPS), devices=4,
                         timeout=300)
    jax_loss = float([ln for ln in out.splitlines()
                      if ln.startswith("LOSS")][0].split()[1])
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ranks = spawn(_rank, 4, ref, timeout=RANK_TIMEOUT)
    return jax_loss, ref["logits"], ranks


@pytest.mark.parametrize("case", ["train", "train_rows", "whole"])
def test_headdim_split_train_step_matches_one_process(hd, case):
    _, _, ranks = hd
    n_attn = build_model(_cfg()).n_groups
    for r in ranks:
        t = r[case]
        assert abs(t["split"] - t["one"]) <= 1e-5 * abs(t["one"]), t
        assert t["excess"] <= 0.0, t
        # each attention layer's forward and its recompute; none whole
        assert t["calls"] == (0 if case == "whole" else 2 * n_attn), t
        assert t["split"] == ranks[0][case]["split"]


@pytest.mark.parametrize("case,head_dim", [("serve", 32),
                                           ("serve_whole", 30)])
def test_headdim_split_prefill_and_decode_match_one_process(hd, case,
                                                            head_dim):
    _, _, ranks = hd
    cfg = _cfg(head_dim)
    n_attn = build_model(cfg).n_groups
    split = head_dim % 4 == 0
    dl = head_dim // 4 if split else head_dim
    for r in ranks:
        s = r[case]
        assert s["gap"] <= 1e-5, s
        # every q head's quarter of head_dim, the cache split the same
        # way; or both whole
        assert s["wq"][1:] == (cfg.d_model, 6, dl), s
        assert s["cache_k"][-2:] == (cfg.n_kv_heads, dl), s
        assert s["decodes"] == (STEPS * n_attn if split else 0), s
        assert s["calls"] == ((STEPS + 1) * n_attn if split else 0), s


def test_headdim_split_matches_the_reference_jitted_step(hd):
    jax_loss, _, ranks = hd
    for r in ranks:
        assert abs(r["train"]["split"] - jax_loss) <= 1e-4, \
            (r["train"]["split"], jax_loss)
        assert abs(r["train"]["one"] - jax_loss) <= 1e-4
        assert r["train"]["excess_jax"] <= 0.0, r["train"]["excess_jax"]


def test_headdim_split_prefill_and_decode_match_the_reference(hd):
    """The reference's jitted prefill and decode on the same (1, 4) mesh,
    where its attention constrains q, k and v on head_dim."""
    _, jax_logits, ranks = hd
    for r in ranks:
        got = r["serve"]["logits"]
        assert len(got) == len(jax_logits) == STEPS + 1
        for g, j in zip(got, jax_logits):
            assert g.shape == j.shape, (g.shape, j.shape)
            gap = float(np.abs(g - j).max())
            assert gap <= 1e-4, gap


def test_headdim_split_bf16_logits_match_one_process(hd):
    """Reduced llama4 in bf16 on (1, 4): prefill and three decode steps
    through the head_dim split, its scores reduced in bf16, within 5e-2
    relative L2 of one process's logits."""
    _, _, ranks = hd
    for r in ranks:
        s = r["bf16"]["serve"]
        assert s["rel"] <= 5e-2, s["rel"]
        assert s["decodes"] == STEPS * build_model(_cfg()).n_groups, s


def test_headdim_split_reduces_scores_at_bf16_width(hd):
    """A bf16 train step's score all-reduces (the forward's, the
    recompute's and the backward's d(p)) move bf16: two bytes an element,
    as the reference's scores in the compute dtype."""
    _, _, ranks = hd
    n_attn = build_model(_cfg()).n_groups
    for r in ranks:
        scores = r["bf16"]["scores"]
        # forward, its recompute under remat, and the backward's two
        assert len(scores) == 4 * n_attn, scores
        for dtype, nbytes, n in scores:
            assert dtype == "bfloat16" and nbytes == 2 * n, scores
