"""The data-parallel step computes the batch's loss, as one process does.

Two gloo CPU ranks (``launch.mesh.spawn``), mesh (data 2, model 1), f32,
against the port's one-process step from the same state and batch:

  * reduced internlm2-1.8b with unequal masks (``targets[:2, 4:] = -1``:
    the first rank's rows hold far fewer targets than the second's): the
    loss within rtol 1e-5, and every gradient too (read from AdamW's
    first moment, with clipping off, so m = (1 - b1) g; within 1e-5 of
    the entry plus 1e-5 of its leaf's largest entry); the JAX
    package's jitted step on a 2-device host mesh, from the same init,
    gives the same loss within 1e-4;
  * reduced llama4-scout-17b-a16e and jamba-v0.1-52b on the pipeline's
    batches: the MoE aux and the loss within 1e-5;
  * each model's mesh step records the spans ``train/forward``,
    ``train/backward`` and ``train/optimizer``, as one process's does;
  * outside a mesh nothing changed: the one-process step's losses, CE,
    aux and params after two steps equal, bit for bit, those of the
    forward as it was before the repair and the split, frozen in
    ``tests/_torch_unsplit_step.py``.

Each spawned run has its own time limit.
"""
import dataclasses
import hashlib
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import state_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models.model import build_model
from repro_torch.obs import Tracer, use_tracer
from repro_torch.sharding.specs import full_tensor, make_axes
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_state, make_train_step,
                                       shard_state)
from repro_torch.tree import tree_leaves

RANK_TIMEOUT = 180
# clipping off: the first moment is (1 - b1) times the gradient itself
OPT = AdamWConfig(warmup_steps=1, total_steps=8, grad_clip=0.0)
MOE_ARCHS = ("llama4-scout-17b-a16e", "jamba-v0.1-52b")


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _masked(batch):
    batch = dict(batch)
    batch["targets"] = batch["targets"].clone()
    batch["targets"][:2, 4:] = -1
    return batch


def _against_one_process(model, state, batch):
    """One step in one process and on mesh (data 2, model 1): the losses,
    aux and the largest excess of the first moments over rtol 1e-5, of
    each entry and of the leaf's largest entry (an entry that sums to ~0
    from the two ranks' halves has no relative precision of its own); and
    the names of the mesh step's spans."""
    one, m1 = make_train_step(model, OPT)(state, batch)
    mesh = make_test_mesh((2, 1), ("data", "model"), "cpu")
    axes = make_axes(mesh)
    with use_tracer(Tracer()) as tr:
        st, m2 = make_train_step(model, OPT, mesh=mesh, axes=axes)(
            shard_state(model, state, mesh, axes), batch)
    excess = max(float(((full_tensor(a) - b).abs()
                        - 1e-5 * (b.abs() + b.abs().max())).max())
                 for a, b in zip(tree_leaves(st["opt_state"]["m"]),
                                 tree_leaves(one["opt_state"]["m"])))
    return {"one": {k: float(m1[k]) for k in ("loss", "ce", "moe_aux")},
            "dp": {k: float(m2[k]) for k in ("loss", "ce", "moe_aux")},
            "m_excess": excess,
            "spans": [sp.name for sp in tr.spans(cat="train")]}


def _dp_rank(rank, world, np_state, np_batch):
    out = {}
    model = build_model(_cfg("internlm2-1.8b"))
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    out["internlm2"] = _against_one_process(
        model, state_from_jax(np_state, "cpu"), batch)
    for arch in MOE_ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg)
        batch = TokenPipeline(cfg, 4, 32, seed=0).next("cpu")
        out[arch] = _against_one_process(model, init_state(model, 0, "cpu"),
                                         batch)
    return out


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
with open({path!r}, "wb") as f:
    pickle.dump((jax.device_get(state), batch), f)
mesh = make_test_mesh((2, 1), ("data", "model"))
axes = make_axes(mesh)
specs = param_specs(state_dims(model), state, axes)
sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                  is_leaf=lambda x: isinstance(x, P))
step = jax.jit(make_train_step(model, AdamWConfig(
    warmup_steps=1, total_steps=8, grad_clip=0.0), axes=axes))
with mesh:
    _, m = step(jax.device_put(state, sh),
                {{k: jnp.asarray(v) for k, v in batch.items()}})
print("LOSS", repr(float(m["loss"])))
"""


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    from tests.conftest import run_subprocess
    path = os.path.join(str(tmp_path_factory.mktemp("dp")), "init.pkl")
    out = run_subprocess(_JAX_STEP.format(path=path), devices=2,
                         timeout=300)
    jax_loss = float([ln for ln in out.splitlines()
                      if ln.startswith("LOSS")][0].split()[1])
    with open(path, "rb") as f:
        np_state, np_batch = pickle.load(f)
    assert (np_batch["targets"] < 0).sum() == 2 * 28 + 2  # + one a row
    ranks = spawn(_dp_rank, 2, np_state, np_batch, timeout=RANK_TIMEOUT)
    assert ranks[0] == ranks[1]          # the data ranks report one step
    return jax_loss, ranks[0]


def test_masked_loss_is_the_batch_mean(dp):
    _, r = dp
    got, want = r["internlm2"]["dp"]["loss"], r["internlm2"]["one"]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_masked_grads_match_one_process(dp):
    _, r = dp
    assert r["internlm2"]["m_excess"] <= 0.0, r["internlm2"]["m_excess"]


def test_masked_loss_matches_the_reference_jitted_step(dp):
    jax_loss, r = dp
    assert abs(r["internlm2"]["dp"]["loss"] - jax_loss) <= 1e-4, \
        (r["internlm2"]["dp"]["loss"], jax_loss)
    assert abs(r["internlm2"]["one"]["loss"] - jax_loss) <= 1e-4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_is_taken_over_the_batch(dp, arch):
    _, r = dp
    one, two = r[arch]["one"], r[arch]["dp"]
    for k in ("moe_aux", "loss"):
        assert abs(two[k] - one[k]) <= 1e-5 * abs(one[k]), (k, two, one)
    assert r[arch]["m_excess"] <= 0.0, r[arch]["m_excess"]


@pytest.mark.parametrize("arch", ("internlm2",) + MOE_ARCHS)
def test_mesh_step_records_the_phase_spans(dp, arch):
    _, r = dp
    assert r[arch]["spans"] == ["train/forward", "train/backward",
                                "train/optimizer"], r[arch]["spans"]


def _two_steps(arch):
    """Two one-process steps on masked batches: (loss, ce, moe_aux) of each
    as float.hex, and the params' bytes."""
    model = build_model(_cfg(arch))
    state = init_state(model, 0, "cpu")
    step = make_train_step(model, AdamWConfig(warmup_steps=1, total_steps=8))
    pipe = TokenPipeline(model.cfg, 4, 32, seed=0)
    got = []
    for _ in range(2):
        state, m = step(state, _masked(pipe.next("cpu")))
        got.append(tuple(float(m[k]).hex() for k in ("loss", "ce", "moe_aux")))
    h = hashlib.blake2b(digest_size=16)
    for t in tree_leaves(state["params"]):
        h.update(t.contiguous().numpy().tobytes())
    return got, h.hexdigest()


@pytest.mark.parametrize("arch", ("internlm2-1.8b",) + MOE_ARCHS)
def test_one_process_step_is_unchanged(arch):
    """Outside a mesh the step is the one before the data-parallel repair
    and the split, bit for bit: against the forward those changes
    rewrote, frozen as it was (``tests/_torch_unsplit_step.py``), in this
    process."""
    from tests._torch_unsplit_step import unsplit
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        now = _two_steps(arch)
        with unsplit():
            before = _two_steps(arch)
    finally:
        torch.set_num_threads(n)
    assert now == before
