"""Cross-mesh checkpoint resharding in the port (the migration core), on 4
gloo CPU ranks (``launch.mesh.spawn``), held against the JAX package's
(4 or 8 forced host devices in a subprocess):

  * ``test_resharding.py::test_save_reshard_restore_roundtrip``'s round
    trip over the 2x2, 4x1 and 1x4 meshes and its five specs, exact, each
    rank's shard also equal to ``distribute_tensor``'s;
  * the JAX package's image of the same values under the same mesh and
    spec has the port's chunks (offset, shape, blake2b key), leaf for
    leaf; each package's image restores in the other onto another mesh,
    exact;
  * a sharded int8 image restores onto another mesh with the host
    decoder's values, bit for bit;
  * ``test_trainer_state_elastic_restore``'s protocol on reduced
    internlm2-1.8b in f32: 2 steps on (2, 2), save, restore on (4, 1)
    with FSDP, 2 steps: the loss within 2e-5 of the 4-step unsharded run
    of both packages; the restored shards equal the saved state's; on a
    mesh with one data-parallel rank the sharded step equals the
    single-process step bit for bit;
  * ``encode_state_on_device`` leaves DTensor leaves to the host codec;
  * ``launch.mesh.spawn`` returns results in rank order, and raises a
    rank's exception, a rank's exit code and its own time limit.

Each spawned run has its own time limit, so a hung collective fails the
test instead of eating the suite's clock. The ranks import this module to
find their functions, so JAX and the reference package are imported only
inside the tests that use them: a rank starts without them.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.ckpt import LocalFSStore, restore, save_checkpoint
from repro_torch.ckpt import compression
from repro_torch.ckpt.layout import host_array, np_dtype
from repro_torch.ckpt.reader import load_manifest
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import state_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models.model import build_model
from repro_torch.sharding.specs import (MeshSharding, distribute,
                                        full_tensor,
                                        local_slice, make_axes,
                                        mesh_placements, param_specs,
                                        shardings)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (make_train_step, shard_state,
                                       state_dims)
from repro_torch.tree import tree_leaves

AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
SPECS = [("data", "model"), ("model", "data"), (None, "model"),
         ("data", None), ()]
RANK_TIMEOUT = 240


def _meshes():
    return {n: make_test_mesh(s, AXES, "cpu") for n, s in MESHES.items()}


# ---------------------------------------------------------------------------
# round trip across meshes
# ---------------------------------------------------------------------------

def _roundtrip_rank(rank, world, root):
    meshes = _meshes()
    return {src: _roundtrip(meshes, root, src) for src in sorted(MESHES)}


def _roundtrip(meshes, root, src):
    x = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32)
    m1 = meshes[src]
    cases = 0
    for i, s1 in enumerate(SPECS):
        pl = mesh_placements(s1, m1)
        xs = distribute(x, m1, pl)
        assert torch.equal(xs.to_local(),
                           distribute_tensor(x, m1, pl).to_local()), s1
        store = LocalFSStore(os.path.join(root, f"{src}-{i}"))
        save_checkpoint(store, "p", 1, {"w": xs})
        whole, _ = restore(store, "p", device="cpu")
        assert not isinstance(whole["w"], DTensor)
        assert torch.equal(whole["w"], x)
        for n2, m2 in meshes.items():
            for s2 in SPECS:
                out, _ = restore(store, "p", device="cpu",
                                 shardings={"w": MeshSharding(m2, s2)})
                w = out["w"]
                assert isinstance(w, DTensor) and tuple(w.shape) == (16, 32)
                assert tuple(w.placements) == mesh_placements(s2, m2)
                assert torch.equal(w.to_local(), local_slice(x, w)), \
                    (src, s1, n2, s2)
                assert torch.equal(full_tensor(w), x), (src, s1, n2, s2)
                cases += 1
    return cases


@pytest.fixture(scope="module")
def roundtrip(tmp_path_factory):
    return spawn(_roundtrip_rank, 4, str(tmp_path_factory.mktemp("rt")),
                 timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("src", sorted(MESHES))
def test_save_reshard_restore_roundtrip(src, roundtrip):
    assert [r[src] for r in roundtrip] == \
        [len(SPECS) * len(MESHES) * len(SPECS)] * 4


# ---------------------------------------------------------------------------
# images across packages
# ---------------------------------------------------------------------------

# (mesh, spec of "w" [16, 32] f32, spec of "b" [8, 64] bf16)
XCASES = [("2x2", ("data", "model"), ("model", None)),
          ("4x1", ("data", None), (None, "data")),
          ("1x4", (None, "model"), ("model", None)),
          ("2x2", (("data", "model"), None), ())]


def _values():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    b = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    return w, b


def _bf16_bits(a):
    """f32 -> bf16 words (round to nearest even), as int16."""
    return compression.f32_to_bf16_bits(a).view(np.int16)


def _port_tree(mesh, sw, sb, step=3):
    w, b = _values()
    bt = torch.from_numpy(_bf16_bits(b)).view(torch.bfloat16)
    return {"params": {
        "w": distribute(torch.from_numpy(w), mesh, mesh_placements(sw, mesh)),
        "b": distribute(bt, mesh, mesh_placements(sb, mesh))},
        "step": torch.tensor(step, dtype=torch.int32),
        "data": {"seed": 0, "step": step}}


def _xpkg_rank(rank, world, root):
    meshes = _meshes()
    w, b = _values()
    out = {}
    for i, (mn, sw, sb) in enumerate(XCASES):
        store = LocalFSStore(os.path.join(root, "port", str(i)))
        man = save_checkpoint(store, "p", 3, _port_tree(meshes[mn], sw, sb))
        out[i] = {n: [li.shape, li.dtype, li.kind,
                      [[list(c.offset), list(c.shape), c.hash, c.key]
                       for c in li.chunks]]
                  for n, li in man.leaves.items()}
        # the JAX image of case i restores onto case i+1's mesh and specs
        mn2, sw2, sb2 = XCASES[(i + 1) % len(XCASES)]
        m2 = meshes[mn2]
        jstore = LocalFSStore(os.path.join(root, "jax", str(i)))
        snap, _ = restore(jstore, "p", device="cpu", shardings={
            "params": {"w": MeshSharding(m2, sw2), "b": MeshSharding(m2, sb2)},
            "step": None, "data": None})
        got_w, got_b = snap["params"]["w"], snap["params"]["b"]
        assert torch.equal(got_w.to_local(),
                           local_slice(torch.from_numpy(w), got_w))
        bits = torch.from_numpy(_bf16_bits(b)).view(torch.bfloat16)
        assert got_b.dtype == torch.bfloat16
        assert torch.equal(got_b.to_local().view(torch.int16),
                           local_slice(bits, got_b).view(torch.int16))
        assert int(snap["step"]) == 3 and snap["data"] == {"seed": 0,
                                                           "step": 3}
    return out


_JAX_WRITE = """
import json, os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import LocalFSStore, save_checkpoint
from repro.ckpt.reader import load_manifest
from repro.launch.mesh import make_test_mesh
root, cases, meshes = {root!r}, {cases!r}, {meshes!r}
rng = np.random.default_rng(7)
w = rng.standard_normal((16, 32)).astype(np.float32)
b = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
out = {{}}
for i, (mn, sw, sb) in enumerate(cases):
    mesh = make_test_mesh(tuple(meshes[mn]), ("data", "model"))
    tree = {{"params": {{
        "w": jax.device_put(jnp.asarray(w), NamedSharding(mesh, P(*sw))),
        "b": jax.device_put(jnp.asarray(b, jnp.bfloat16),
                            NamedSharding(mesh, P(*sb)))}},
        "step": jnp.asarray(3, jnp.int32),
        "data": {{"seed": 0, "step": 3}}}}
    store = LocalFSStore(os.path.join(root, "jax", str(i)))
    man = save_checkpoint(store, "p", 3, tree)
    out[i] = {{n: [list(li.shape), li.dtype, li.kind,
                  [[list(c.offset), list(c.shape), c.hash, c.key]
                   for c in li.chunks]] for n, li in man.leaves.items()}}
print("MANIFESTS" + json.dumps(out))
"""

_JAX_READ = """
import os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import LocalFSStore, restore
from repro.launch.mesh import make_test_mesh
root, cases, meshes = {root!r}, {cases!r}, {meshes!r}
rng = np.random.default_rng(7)
w = rng.standard_normal((16, 32)).astype(np.float32)
b = np.asarray(jnp.asarray(
    (rng.standard_normal((8, 64)) * 3).astype(np.float32), jnp.bfloat16))
for i in range(len(cases)):
    mn2, sw2, sb2 = cases[(i + 1) % len(cases)]
    mesh = make_test_mesh(tuple(meshes[mn2]), ("data", "model"))
    store = LocalFSStore(os.path.join(root, "port", str(i)))
    snap, _ = restore(store, "p", shardings={{
        "params": {{"w": NamedSharding(mesh, P(*sw2)),
                    "b": NamedSharding(mesh, P(*sb2))}},
        "step": None, "data": None}})
    assert snap["params"]["w"].sharding.spec == P(*sw2)
    assert snap["params"]["b"].sharding.spec == P(*sb2)
    np.testing.assert_array_equal(np.asarray(snap["params"]["w"]), w)
    assert np.asarray(snap["params"]["b"]).tobytes() == b.tobytes()
    assert int(snap["step"]) == 3 and snap["data"] == {{"seed": 0,
                                                        "step": 3}}
print("READ", len(cases))
"""


def test_sharded_images_cross_packages(tmp_path):
    from tests.conftest import run_subprocess
    root = str(tmp_path)
    fill = dict(root=root, cases=XCASES, meshes=MESHES)
    out = run_subprocess(_JAX_WRITE.format(**fill), devices=4)
    line = [ln for ln in out.splitlines() if ln.startswith("MANIFESTS")][0]
    jax_leaves = json.loads(line[len("MANIFESTS"):])
    port = spawn(_xpkg_rank, 4, root, timeout=RANK_TIMEOUT)
    for rank_out in port:           # every rank returns the same manifest
        assert rank_out == port[0]
    for i in range(len(XCASES)):
        got = {n: [list(v[0]), v[1], v[2], v[3]]
               for n, v in port[0][i].items()}
        assert got == jax_leaves[str(i)], XCASES[i]
        n_chunks = {n: len(v[3]) for n, v in got.items()}
        mesh = MESHES[XCASES[i][0]]
        assert n_chunks["params/w"] == np.prod(
            [mesh[AXES.index(a)] for e in XCASES[i][1] if e
             for a in (e if isinstance(e, tuple) else (e,))])
        assert n_chunks["step"] == n_chunks["data/seed"] == 1
    out = run_subprocess(_JAX_READ.format(**fill), devices=4)
    assert f"READ {len(XCASES)}" in out


# ---------------------------------------------------------------------------
# int8 sharded images
# ---------------------------------------------------------------------------

def _int8_rank(rank, world, root):
    meshes = _meshes()
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((16, 600)) * 2).astype(np.float32)
    w[:, :256] = 0.0                                  # all-zero blocks
    b = torch.from_numpy(_bf16_bits(rng.standard_normal((8, 512))
                                    .astype(np.float32))).view(torch.bfloat16)
    m1 = meshes["2x2"]
    tree = {"w": distribute(torch.from_numpy(w), m1,
                             mesh_placements(("data", "model"), m1)),
            "b": distribute(b, m1, mesh_placements(("model", "data"), m1))}
    store = LocalFSStore(root)
    man = save_checkpoint(store, "q", 1, tree, codec="int8")
    host = {}
    for name, li in man.leaves.items():                 # the host decoder
        full = np.zeros(li.shape, np_dtype(li.dtype))
        for c in li.chunks:
            raw = compression.decode(store.get(c.key), li.dtype, man.codec)
            sl = tuple(slice(o, o + s) for o, s in zip(c.offset, c.shape))
            full[sl] = np.frombuffer(raw, np_dtype(li.dtype)).reshape(c.shape)
        host[name] = full
    checked = 0
    for mn, m2 in meshes.items():
        for sw, sb in ((("data", None), (None, "model")),
                       ((None, "model"), ("data", "model"))):
            out, _ = restore(store, "q", device="cpu", shardings={
                "w": MeshSharding(m2, sw), "b": MeshSharding(m2, sb)})
            for name, t in out.items():
                want = torch.from_numpy(host[name])
                assert np.array_equal(host_array(t.to_local()),
                                      local_slice(want, t).numpy()), \
                    (mn, name)
                checked += 1
    return checked, len(man.leaves["w"].chunks)


def test_int8_sharded_image_restores_host_decoder_values(tmp_path):
    res = spawn(_int8_rank, 4, str(tmp_path), timeout=RANK_TIMEOUT)
    assert res == [(12, 4)] * 4


# ---------------------------------------------------------------------------
# the elastic trainer protocol
# ---------------------------------------------------------------------------

def _cfg():
    return dataclasses.replace(treduced(tget_config("internlm2-1.8b")),
                               dtype="float32")


OPT = AdamWConfig(warmup_steps=1, total_steps=8)


def _elastic_rank(rank, world, root, np_state):
    cfg = _cfg()
    model = build_model(cfg)
    state0 = state_from_jax(np_state, "cpu")
    single = make_train_step(model, OPT)
    out = {}
    # the unsharded run, on every rank
    s, pipe, losses, states = state0, TokenPipeline(cfg, 4, 32, seed=0), [], []
    for _ in range(4):
        s, m = single(s, pipe.next("cpu"))
        losses.append(float(m["loss"]))
        states.append(s)
    out["ref"] = losses
    # one data-parallel rank (1, 4): the single-process step, bit for bit
    m14 = make_test_mesh((1, 4), AXES, "cpu")
    st = shard_state(model, state0, m14, make_axes(m14))
    step14 = make_train_step(model, OPT, mesh=m14)
    pipe = TokenPipeline(cfg, 4, 32, seed=0)
    exact = []
    for k in range(2):
        st, m = step14(st, pipe.next("cpu"))
        exact.append(float(m["loss"]) == losses[k] and all(
            torch.equal(a.to_local(), local_slice(b, a))
            for a, b in zip(tree_leaves(st), tree_leaves(states[k]))))
    out["dp1_exact"] = exact
    # 2 steps on (2, 2), save, restore on (4, 1) with FSDP, 2 steps
    mesh1 = make_test_mesh((2, 2), AXES, "cpu")
    axes1 = make_axes(mesh1)
    st = shard_state(model, state0, mesh1, axes1)
    step1 = make_train_step(model, OPT, mesh=mesh1, axes=axes1)
    pipe2 = TokenPipeline(cfg, 4, 32, seed=0)
    for _ in range(2):
        st, _ = step1(st, pipe2.next("cpu"))
    saved = [full_tensor(t) for t in tree_leaves(st)]
    store = LocalFSStore(root)
    save_checkpoint(store, "t", 2, {"state": st, "data": pipe2.state_dict()})
    mesh2 = make_test_mesh((4, 1), AXES, "cpu")
    axes2 = make_axes(mesh2, use_fsdp=True)
    specs2 = param_specs(state_dims(model), state0, axes2)
    snap, _ = restore(store, "t", device="cpu",
                      shardings={"state": shardings(specs2, mesh2),
                                 "data": None})
    st3 = snap["state"]
    out["restored_exact"] = all(
        torch.equal(t.to_local(), local_slice(full, t))
        for t, full in zip(tree_leaves(st3), saved))
    moved = [tuple(a.placements) != tuple(b.placements)
             for a, b in zip(tree_leaves(st), tree_leaves(st3))]
    out["moved"] = sum(moved)
    pipe3 = TokenPipeline(cfg, 4, 32, seed=0)
    pipe3.load_state_dict(snap["data"])
    step2 = make_train_step(model, OPT, mesh=mesh2, axes=axes2)
    for _ in range(2):
        st3, m3 = step2(st3, pipe3.next("cpu"))
    out["elastic"] = float(m3["loss"])
    return out


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    from repro.configs import get_config, reduced
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro.models import build_model as jbuild
    from repro.train import AdamWConfig as JAdamW
    from repro.train import init_state, make_train_step as jstep
    import jax
    import jax.numpy as jnp
    cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                              dtype="float32")
    model = jbuild(cfg)
    state = init_state(model, jax.random.PRNGKey(0))
    np_state = jax.device_get(state)
    step = jax.jit(jstep(model, JAdamW(warmup_steps=1, total_steps=8)))
    pipe = JPipeline(cfg, 4, 32, seed=0)
    for _ in range(4):
        b = {k: jnp.asarray(v) for k, v in pipe.next().items()}
        state, m = step(state, b)
    root = str(tmp_path_factory.mktemp("elastic"))
    ranks = spawn(_elastic_rank, 4, root, np_state, timeout=RANK_TIMEOUT)
    return float(m["loss"]), ranks


def test_elastic_restore_matches_both_packages(elastic):
    jax_loss, ranks = elastic
    for r in ranks:
        assert r["elastic"] == ranks[0]["elastic"]
        assert abs(r["elastic"] - jax_loss) < 2e-5, (r["elastic"], jax_loss)
        assert abs(r["elastic"] - r["ref"][-1]) < 2e-5, (r["elastic"],
                                                         r["ref"])
        assert abs(r["ref"][-1] - jax_loss) < 2e-5


def test_restored_shards_equal_the_saved_state(elastic):
    _, ranks = elastic
    for r in ranks:
        assert r["restored_exact"]
        assert r["moved"] > 0          # the restore changed leaves' layout


def test_one_data_rank_sharded_step_is_the_single_step(elastic):
    _, ranks = elastic
    for r in ranks:
        assert r["dp1_exact"] == [True, True]


# ---------------------------------------------------------------------------
# device encode of a sharded state
# ---------------------------------------------------------------------------

def _encode_rank(rank, world, root):
    from repro_torch.ckpt.layout import PreEncodedLeaf
    from repro_torch.train.trainer import encode_state_on_device
    mesh = make_test_mesh((2, 1), AXES, "cpu")
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal((8, 300)) * 2)
                         .astype(np.float32))
    norm = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    tree = {"w": distribute(w, mesh, mesh_placements(("data", None), mesh)),
            "norm": norm}
    enc = encode_state_on_device(tree)
    assert isinstance(enc["w"], DTensor), type(enc["w"])
    assert isinstance(enc["norm"], PreEncodedLeaf)
    a = save_checkpoint(LocalFSStore(os.path.join(root, "dev")), "p", 1,
                        enc, codec="int8")
    b = save_checkpoint(LocalFSStore(os.path.join(root, "host")), "p", 1,
                        tree, codec="int8")
    chunks = lambda m: {n: [(c.offset, c.shape, c.hash) for c in li.chunks]
                        for n, li in m.leaves.items()}
    assert chunks(a) == chunks(b)
    return len(a.leaves["w"].chunks)


def test_device_encode_leaves_dtensors_to_the_host_codec(tmp_path):
    """A DTensor leaf is not quantized as a whole leaf on its device: it
    stays a DTensor, and the writer encodes each rank's shards on the
    host, into the bytes of the host int8 codec."""
    assert spawn(_encode_rank, 2, str(tmp_path),
                 timeout=RANK_TIMEOUT) == [2, 2]


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------

def _raise_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank one refuses")
    return rank


def _exit_on_rank_0(rank, world):
    if rank == 0:
        os._exit(3)
    import time
    time.sleep(60)


def _sleep(rank, world):
    import time
    time.sleep(60)


def test_spawn_returns_results_in_rank_order():
    assert spawn(_raise_on_rank_1, 1, timeout=60) == [0]


def test_spawn_raises_a_rank_exception():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        spawn(_raise_on_rank_1, 2, timeout=60)
    assert "ValueError: rank one refuses" in str(err.value)


def test_spawn_raises_a_rank_exit_code():
    with pytest.raises(RuntimeError, match="rank 0 exited with code 3"):
        spawn(_exit_on_rank_0, 2, timeout=60)


def test_spawn_time_limit():
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="outlasted 8"):
        spawn(_sleep, 2, timeout=8)
    assert time.monotonic() - t0 < 30
