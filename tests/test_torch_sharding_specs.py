"""The port's logical-dims → mesh-axes rules against the JAX package's.

  * every case of ``tests/test_sharding_specs.py``: the port's
    ``leaf_spec`` equals the reference's ``PartitionSpec`` entry for entry;
  * for every config in the catalog, at full width: ``param_dims``,
    ``state_dims`` and ``batch_dims`` equal the reference's,
    ``abstract_params`` (``meta`` tensors) has ``jax.eval_shape``'s shapes
    and dtypes, ``batch_struct`` the reference's, and ``param_specs`` are
    equal under the 16x16 axes, the 2x16x16 pod axes and a 2x2 mesh's;
  * ``mesh_placements`` + ``local_region`` give each rank the offset and
    shape that the reference's ``devices_indices_map`` gives its device,
    on 2x2, 4x1, 1x4 and 2x2x2 (pod, data, model) meshes, a
    ``("pod", "data")`` entry included.
"""
import json
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_REGISTRY, get_config
from repro.models import build_model as jbuild
from repro.sharding.specs import MeshAxes as JMeshAxes
from repro.sharding.specs import leaf_spec as jleaf_spec
from repro.sharding.specs import param_specs as jparam_specs
from repro.train.trainer import state_dims as jstate_dims
from repro_torch.configs import get_config as tget_config
from repro_torch.models.model import build_model as tbuild
from repro_torch.sharding.specs import (MeshAxes, leaf_spec, local_region,
                                        make_axes, mesh_placements,
                                        param_specs)
from repro_torch.train.trainer import state_dims
from repro_torch.tree import leaves_with_path
from tests.conftest import run_subprocess

AX = dict(dp=("data",), fsdp="data", tp="model", ep="model", sp=None,
          sizes={"data": 16, "model": 16})
AX_POD = dict(dp=("pod", "data"), fsdp="data", tp="model", ep="model",
              sp=None, sizes={"pod": 2, "data": 16, "model": 16})
SMALL = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
ARCHS = sorted(ARCH_REGISTRY)

# (dims, shape, axes) of every case in tests/test_sharding_specs.py
LEAF_CASES = [
    (("embed", "ff"), (4096, 14336), "AX"),
    (("vocab", "embed"), (49152, 4096), "AX"),
    (("embed_nt",), (4096,), "AX"),
    (("embed", "ff"), (100, 14336), "AX"),
    (("embed", "heads", "head_dim"), (5120, 40, 128), "AX"),
    (("embed", "heads", "head_dim"), (4096, 32, 128), "AX"),
    (("embed", "kv_heads", "head_dim"), (4096, 8, 128), "AX"),
    (("layers", "batch", "kvseq", "kv_heads", "head_dim"),
     (24, 128, 32768, 8, 128), "AX"),
    (("experts", "moe_embed", "moe_ff"), (128, 5120, 8192), "AX"),
    (("layers", "batch", "kvseq", "kv_heads", "head_dim"),
     (24, 128, 32768, 8, 128), "AX_POD"),
    (("layers", "batch", "kvseq", "kv_heads", "head_dim"),
     (24, 1, 524288, 8, 128), "AX_POD"),
]


def _axes(name):
    """(port MeshAxes, reference MeshAxes) of one axes name."""
    if name == "2x2":
        t = make_axes(SMALL, use_fsdp=True)
        return t, JMeshAxes(dp=t.dp, fsdp=t.fsdp, tp=t.tp, ep=t.ep, sp=t.sp,
                            sizes=dict(t.sizes))
    kw = {"AX": AX, "AX_POD": AX_POD}[name]
    return MeshAxes(**kw), JMeshAxes(**kw)


def _norm(tree):
    """A dims tree with tuple leaves, as plain dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tuple(tree)


def _spec_paths(tree, path=()):
    """{path: spec tuple} of a port spec tree (dicts of tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, path + (k,)))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("dims,shape,axes", LEAF_CASES)
def test_leaf_spec_matches_reference(dims, shape, axes):
    t, j = _axes(axes)
    want = jleaf_spec(dims, shape, j)
    got = leaf_spec(dims, shape, t)
    assert got == tuple(want), (got, want)
    assert len(got) == len(dims)


def test_make_axes_reads_the_mesh():
    ax = make_axes(types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 2)),
        use_fsdp=True, seq_shard=True)
    assert ax == MeshAxes(dp=("pod", "data"), fsdp="data", tp="model",
                          ep="model", sp="model",
                          sizes={"pod": 2, "data": 4, "model": 2})
    ax = make_axes(types.SimpleNamespace(mesh_dim_names=("pod",),
                                         shape=(2,)))
    assert (ax.dp, ax.fsdp, ax.tp, ax.sp) == (("pod",), None, None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_dims_trees_match_reference(arch):
    jm, tm = jbuild(get_config(arch)), tbuild(tget_config(arch))
    assert _norm(tm.param_dims()) == _norm(jm.param_dims())
    assert _norm(state_dims(tm)) == _norm(jstate_dims(jm))
    assert _norm(tm.batch_dims()) == _norm(jm.batch_dims())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_eval_shape(arch):
    jm, tm = jbuild(get_config(arch)), tbuild(tget_config(arch))
    want = jax.tree_util.tree_flatten_with_path(jm.abstract_params())[0]
    got = leaves_with_path(tm.abstract_params())
    assert [tuple(k.key for k in p) for p, _ in want] == \
        [p for p, _ in got]
    for (_, w), (name, g) in zip(want, got):
        assert g.device.type == "meta", name
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
    for B, S in ((8, 512), (2, 1040)):
        jb, tb = jm.batch_struct(B, S), tm.batch_struct(B, S)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tuple(tb[k].shape) == tuple(jb[k].shape), k
            assert str(tb[k].dtype).removeprefix("torch.") == \
                str(jb[k].dtype), k


@pytest.mark.parametrize("axes", ["AX", "AX_POD", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, axes):
    t, j = _axes(axes)
    jm, tm = jbuild(get_config(arch)), tbuild(tget_config(arch))
    want = jparam_specs(jm.param_dims(), jm.abstract_params(), j)
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0]
    want = {tuple(k.key for k in p): tuple(s) for p, s in flat}
    got = _spec_paths(param_specs(tm.param_dims(), tm.abstract_params(), t))
    assert got == want
    # every sharded dim divides evenly: each rank's shard is whole
    shapes = dict(leaves_with_path(tm.abstract_params()))
    for path, spec in got.items():
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([t.sizes[a] for a in names]))
            assert shapes[path].shape[d] % n == 0, (path, spec)


# meshes and specs whose per-device regions the reference reports
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SPECS = {"2x2": [("data", "model"), ("model", "data"), (None, "model"),
                 ("data", None), ()],
         "2x2x2": [(("pod", "data"), "model"), ("model", ("pod", "data")),
                   (("pod", "data", "model"), None), ("pod", None),
                   (None, ("data", "model")), ()]}
SPECS["4x1"] = SPECS["1x4"] = SPECS["2x2"]
SHAPE = (16, 32)


@pytest.fixture(scope="module")
def reference_regions():
    """{(mesh, spec index): [(offset, shape) per device, flat order]} from
    the reference's ``devices_indices_map`` on 8 forced host devices."""
    out = run_subprocess(f"""
    import json
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_test_mesh
    meshes, specs = {MESHES!r}, {SPECS!r}
    out = {{}}
    for name, (shape, axes) in meshes.items():
        mesh = make_test_mesh(shape, axes)
        for i, spec in enumerate(specs[name]):
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map({SHAPE})
            rows = []
            for dev in mesh.devices.flat:
                off = [s.start or 0 for s in idx[dev]]
                shp = [(s.stop if s.stop is not None else d) - o
                       for s, d, o in zip(idx[dev], {SHAPE}, off)]
                rows.append([off, shp])
            out[f"{{name}}/{{i}}"] = rows
    print("REGIONS" + json.dumps(out))
    """, devices=8)
    line = [ln for ln in out.splitlines() if ln.startswith("REGIONS")][0]
    return json.loads(line[len("REGIONS"):])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_regions_match_devices_indices_map(mesh, reference_regions):
    shape, axes = MESHES[mesh]
    fake = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    for i, spec in enumerate(SPECS[mesh]):
        placements = mesh_placements(spec, fake)
        for flat, (off, shp) in enumerate(reference_regions[f"{mesh}/{i}"]):
            coord = np.unravel_index(flat, shape)
            got = local_region(SHAPE, placements, shape,
                               [int(c) for c in coord])
            assert got == (tuple(off), tuple(shp)), (mesh, spec, flat)


def test_placements_refuse_what_dtensor_cannot_hold():
    fake = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    with pytest.raises(ValueError, match="mesh order"):
        mesh_placements((("data", "pod"), None), fake)
    with pytest.raises(ValueError, match="shards two dims"):
        mesh_placements(("data", "data"), fake)
    pl = mesh_placements(("data", None), fake)
    with pytest.raises(ValueError, match="evenly"):
        local_region((15, 32), pl, (2, 2, 2), (0, 1, 0))
