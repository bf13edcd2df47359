"""The port's dry-run machinery (port of ``tests/test_dryrun_small.py``):
collective accounting from ``specs.collective_log`` records, the
roofline at H100 constants, ``model_flops`` against the reference's, and
cells traced on ``meta`` tensors in a ``fake``-backend world.

Every process group lives in a subprocess of its own (one group a
process): the traced cells in a ``fake`` world, their real counterparts
on gloo ranks (``launch.mesh.spawn``), the CLI. The reference test's
promoted all-reduce case has no counterpart: XLA:CPU widens bf16
all-reduces to f32 in its HLO and the reference halves them back, while
torch reduces a bf16 tensor as bf16, which the record shows.
"""
import dataclasses
import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import pytest

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 reduced, shape_applicable)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analysis
from repro_torch.launch.mesh import spawn

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300
# reduced stand-ins of one kind each for the (1, 2) cells, traced and run
SMALL = {"train_4k": ShapeConfig("train_4k", 32, 4, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 32, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 32, 4, "decode")}
# and of the context-parallel decode cell: batch 1, 32 slots
CP_SMALL = {"long_500k": ShapeConfig("long_500k", 32, 1, "decode")}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _python(code: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                           *args], capture_output=True, text=True,
                          timeout=TIMEOUT, env=_env(), cwd=str(ROOT))


def _rec(kind, nbytes, ranks, dtype="float32"):
    return {"kind": kind, "bytes": nbytes, "dtype": dtype, "group": None,
            "ranks": tuple(ranks), "site": "test"}


def test_collective_accounting():
    recs = [_rec("all_gather", 8 * 128 * 2, range(2), "bfloat16"),
            _rec("all_reduce", 256 * 4, range(16)),
            _rec("all_reduce", 256 * 2, range(4), "bfloat16"),
            _rec("all_gather", 1024, range(0, 64, 16))]
    out = analysis.collective_bytes(recs)
    assert out["all-gather_bytes"] == 8 * 128 * 2 + 1024
    assert out["all-reduce_bytes"] == 256 * 4 + 256 * 2
    assert out["all-gather_count"] == 2 and out["all-reduce_count"] == 2
    per_op = {k: v for k, v in out.items()
              if k.endswith("_bytes") and k not in (
                  "total_bytes", "total_link_bytes", "nvlink_link_bytes",
                  "ib_link_bytes")}
    assert out["total_bytes"] == sum(per_op.values())
    # link accounting: a ring all-reduce moves ~2x its buffer
    assert out["total_link_bytes"] == (out["total_bytes"]
                                       + out["all-reduce_bytes"])
    # ranks 0..15 and 0, 16, 32, 48 span nodes of 8; 0..1 and 0..3 do not
    assert out["ib_link_bytes"] == 2 * 256 * 4 + 1024
    assert out["nvlink_link_bytes"] == 8 * 128 * 2 + 2 * 256 * 2
    assert out["nvlink_link_bytes"] + out["ib_link_bytes"] == \
        out["total_link_bytes"]
    top = analysis.top_collectives(recs + recs[:1], k=2)
    assert top[0] == (2 * 8 * 128 * 2, "all-gather", "test", 2), top


def test_collective_accounting_takes_a_reduce_scatter():
    """A reduce-scatter's record is the shard it leaves (the reference's
    result buffer): counted once in the link bytes, and its buffers read
    whole and written as the shard."""
    recs = [_rec("reduce_scatter", 4096, range(4), "bfloat16"),
            _rec("reduce_scatter", 1024, range(0, 32, 8)),
            _rec("all_gather", 16384, range(4), "bfloat16")]
    out = analysis.collective_bytes(recs)
    assert out["reduce-scatter_bytes"] == 4096 + 1024
    assert out["reduce-scatter_count"] == 2
    assert out["total_link_bytes"] == 4096 + 1024 + 16384
    assert out["ib_link_bytes"] == 1024
    assert out["nvlink_link_bytes"] == 4096 + 16384
    top = analysis.top_collectives(recs, k=3)
    assert (4096, "reduce-scatter", "test", 1) in top, top

    class _Counter:
        fused_bytes = flash_bytes = 0
    fused = analysis.fused_memory_bytes(_Counter(), recs[:1])
    assert fused["fused_bytes"] == 4 * 4096 + 4096


def _seen_seq_shard(low, arch, shape):
    """The ``seq_shard`` that ``low.build_cell`` hands ``make_axes`` for
    (arch, shape), caught there before anything is built; None for a
    cell ``shape_applicable`` rules out."""
    class _Seen(Exception):
        pass

    def spy(mesh, **kw):
        raise _Seen(kw.get("seq_shard"))
    saved = low.make_axes
    low.make_axes = spy
    try:
        low.build_cell(arch, shape, None)
    except _Seen as e:
        return e.args[0]
    except low.SkipCell:
        return None
    finally:
        low.make_axes = saved


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ASSIGNED_ARCHS
                                        for s in SHAPES], ids=str)
def test_build_cell_seq_shard_default_is_the_reference_rule(arch, shape):
    """``build_cell``'s default ``seq_shard`` is the one the reference's
    ``build_cell`` hands its ``make_axes``, for every (arch, shape) of
    the catalog (and a cell either skips, both skip)."""
    import repro.launch.lowering as ref_low
    import repro_torch.launch.lowering as low
    want = _seen_seq_shard(ref_low, arch, shape)
    assert _seen_seq_shard(low, arch, shape) == want
    if want is not None:
        assert low.default_seq_shard(get_config(arch),
                                     SHAPES[shape]) == want


def test_roofline_terms():
    cfg = get_config("internlm2-1.8b")
    shape = SHAPES["train_4k"]
    cost = {"flops": analysis.PEAK_FLOPS, "bytes accessed": analysis.HBM_BW}
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    r = analysis.roofline(cost, {"total_bytes": analysis.IB_BW}, cfg, shape,
                          n_chips=256)
    assert abs(r["compute_s"] - 1.0) < 1e-9
    assert abs(r["memory_s"] - 1.0) < 1e-9
    assert abs(r["collective_s"] - 1.0) < 1e-9
    assert r["model_flops"] > 6 * cfg.param_count() * 256 * 4096 * 0.9
    coll = {"total_bytes": 0, "nvlink_link_bytes": analysis.NVLINK_BW,
            "ib_link_bytes": 2 * analysis.IB_BW}
    r = analysis.roofline(cost, coll, cfg, shape, n_chips=256,
                          fused={"fused_bytes": analysis.HBM_BW / 2,
                                 "fused_flash_bytes": analysis.HBM_BW / 4})
    assert abs(r["collective_s"] - 3.0) < 1e-9
    assert r["dominant"] == "collective" and r["step_bound_s"] == 3.0
    assert abs(r["memory_flash_s"] - 0.25) < 1e-9


def _live_cells():
    return [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
            if shape_applicable(get_config(a), SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", _live_cells(), ids=str)
def test_model_flops_equals_the_reference(arch, shape):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch.analysis import model_flops as ref_flops
    assert analysis.model_flops(get_config(arch), SHAPES[shape]) == \
        ref_flops(ref_config(arch), REF_SHAPES[shape])


_CELL_8 = """
import json
import repro_torch.configs as C
import repro_torch.launch.lowering as low
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import fake_world, make_test_mesh
fake_world(8)
mesh = make_test_mesh((2, 4), ("data", "model"), "meta")
# the reference test's stand-in for train_4k: global batch 8 x 256
tiny = ShapeConfig("train_4k", 256, 8, "train")
C.SHAPES["train_4k"] = tiny
low.SHAPES["train_4k"] = tiny
out = low.lower_and_analyze(dict(arch="internlm2-1.8b", shape="train_4k"),
                            mesh)
print(json.dumps(out))
"""

_REF_ARG_BYTES = """
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.sharding.specs import make_axes, param_specs
from repro.train.trainer import init_state, state_dims
cfg = get_config("internlm2-1.8b")
model = build_model(cfg)
mesh = make_test_mesh((2, 4), ("data", "model"))
axes = make_axes(mesh, use_fsdp=cfg.use_fsdp, seq_shard=True)
total = 0
for tree, dims in (
        (jax.eval_shape(lambda: init_state(model, jax.random.PRNGKey(0))),
         state_dims(model)),
        (model.batch_struct(8, 256), model.batch_dims())):
    specs = param_specs(dims, tree, axes)
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    for x, s in zip(leaves, spec_leaves):
        shard = NamedSharding(mesh, s).shard_shape(x.shape)
        total += int(np.prod(shard)) * np.dtype(x.dtype).itemsize
print("ARG_BYTES", total)
"""


@pytest.fixture(scope="module")
def cell8():
    r = _python(_CELL_8)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dryrun_cell_on_small_mesh(cell8):
    """build_cell + lower_and_analyze end to end on a (2, 4) fake world."""
    out = cell8
    assert out["flops_per_device"] > 0
    assert out["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert out["memory_analysis"]["argument_size_in_bytes"] > 0
    assert out["memory_analysis"]["temp_size_in_bytes"] > 0
    assert 0 < out["roofline"]["useful_flops_ratio"] < 2.0
    assert out["mesh"] == "2x4" and out["n_chips"] == 8
    # one all-reduce after each attention and MLP block, forward, remat
    # recompute and backward; the gradients summed over the data axis
    assert out["collectives"]["all-reduce_count"] > 0


def test_argument_bytes_equal_the_reference_shards(cell8):
    from tests.conftest import run_subprocess
    ref = int([ln for ln in run_subprocess(_REF_ARG_BYTES, devices=8,
                                           timeout=TIMEOUT).splitlines()
               if ln.startswith("ARG_BYTES")][0].split()[1])
    assert cell8["memory_analysis"]["argument_size_in_bytes"] == ref


def _small_config(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _patch_small(low):
    """Reduced configs and SMALL's shapes under the real cell names."""
    low.get_config = _small_config
    low.SHAPES = dict(low.SHAPES, **SMALL, **CP_SMALL)


def _step_collectives(arch, shape, device, mesh_shape=(1, 2),
                      seq_shard=None):
    import repro_torch.launch.lowering as low
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import specs as SH
    _patch_small(low)
    mesh = make_test_mesh(mesh_shape, ("data", "model"), device)
    cell = low.build_cell(arch, shape, mesh, device=device,
                          seq_shard=seq_shard)
    with SH.collective_log() as log:
        cell.step(*cell.args)
    return [(r["kind"], r["bytes"], r["ranks"], r["site"]) for r in log]


def _traced(arch, shape, mesh_shape=(1, 2), seq_shard=None):
    from repro_torch.launch.mesh import fake_world
    fake_world(2)
    return _step_collectives(arch, shape, "meta", mesh_shape, seq_shard)


def _gloo_rank(rank, world, arch, shape, mesh_shape=(1, 2),
               seq_shard=None):
    return _step_collectives(arch, shape, "cpu", mesh_shape, seq_shard)


@pytest.mark.parametrize("arch,shape", [
    ("internlm2-1.8b", s) for s in sorted(SMALL)] + [
    ("internvl2-2b", "decode_32k"), ("seamless-m4t-medium", "prefill_32k"),
    ("jamba-v0.1-52b", "prefill_32k"), ("xlstm-125m", "train_4k")],
    ids=str)
def test_traced_collectives_equal_a_real_run(arch, shape):
    """One rank's step of a (1, 2) cell traced on meta tensors issues the
    collectives, buffer for buffer, that the same step issues run for
    real on two gloo ranks (a vlm's decode token, an enc-dec prefill, the
    split Mamba and xLSTM blocks' all-to-alls and all-gathers too)."""
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        traced = ex.submit(_traced, arch, shape).result(timeout=TIMEOUT)
    real = spawn(_gloo_rank, 2, arch, shape, timeout=TIMEOUT)
    assert traced, "no collective traced"
    assert traced == real[0], (len(traced), len(real[0]))


@pytest.mark.parametrize("seq_shard", [True, False])
def test_a_seq_shard_train_cell_traces_as_a_real_run(seq_shard):
    """A (1, 2) reduced internlm2 train cell with ``seq_shard`` on issues,
    traced on meta, the collectives two gloo ranks issue, its
    reduce-scatters included (the blocks' exits forward, the gathers'
    backward); with it off, none."""
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        traced = ex.submit(_traced, "internlm2-1.8b", "train_4k", (1, 2),
                           seq_shard).result(timeout=TIMEOUT)
    real = spawn(_gloo_rank, 2, "internlm2-1.8b", "train_4k", (1, 2),
                 seq_shard, timeout=TIMEOUT)
    assert traced == real[0], (len(traced), len(real[0]))
    kinds = {r[0] for r in traced}
    assert ("reduce_scatter" in kinds) == seq_shard, kinds


_SEQ_TEMP = """
import json
import repro_torch.launch.lowering as low
from repro_torch.launch.mesh import fake_world, make_test_mesh
from tests.test_torch_dryrun_small import _patch_small
from repro_torch.configs.base import ShapeConfig
fake_world(2)
_patch_small(low)
# long enough that the block inputs remat keeps outweigh the optimizer's
low.SHAPES["train_4k"] = ShapeConfig("train_4k", 1024, 4, "train")
mesh = make_test_mesh((1, 2), ("data", "model"), "meta")
rows = {}
for on in (None, False):
    row = low.lower_and_analyze(dict(arch="internlm2-1.8b",
                                     shape="train_4k", seq_shard=on), mesh)
    rows[str(on)] = {"seq_shard": row["seq_shard"],
                     "temp": row["memory_analysis"]["temp_size_in_bytes"],
                     "rs": row["collectives"]["reduce-scatter_count"]}
print(json.dumps(rows))
"""


def test_seq_shard_lowers_a_train_cells_temp_bytes():
    """A (1, 2) reduced internlm2 train cell of 4 x 1024 takes
    ``seq_shard`` by default, records it, and holds fewer temp bytes a
    rank than the same cell with it off."""
    r = _python(_SEQ_TEMP)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    on, off = rows["None"], rows["False"]
    assert on["seq_shard"] is True and off["seq_shard"] is False, rows
    assert on["rs"] > 0 and off["rs"] == 0, rows
    assert on["temp"] < off["temp"], rows


_ONE_HEAD = """
import dataclasses, json
import repro_torch.launch.lowering as low
from repro_torch.launch.mesh import fake_world, make_test_mesh
from tests.test_torch_dryrun_small import _patch_small, _small_config
from repro_torch.configs.base import ShapeConfig
fake_world(4)
_patch_small(low)
# d_model 32x head_dim: wo's row-parallel product of one q head a rank,
# [512, 32] @ [32, 1024], grows its inputs over 10x, more than a score's
# [1, 512, 32] @ [1, 32, 512] (8x), and its output [512, 1024] is not a
# score's shape
low.get_config = lambda a: dataclasses.replace(_small_config(a),
                                               d_model=1024)
low.SHAPES["train_4k"] = ShapeConfig("train_4k", 512, 1, "train")
mesh = make_test_mesh((1, 4), ("data", "model"), "meta")
rows = {}
for on in (True, False):
    cell = low.build_cell("internlm2-1.8b", "train_4k", mesh, seq_shard=on)
    res = low._trace_cell(cell, track_memory=False)
    rows[str(on)] = dict(res["fused"], left_out=[
        [list(k), v] for k, v in res["left_out"].items()])
print(json.dumps(rows))
"""


def test_flash_bytes_leave_out_only_the_scores_at_one_q_head_a_rank():
    """A reduced internlm2 train cell of 1 x 512 with its 4 q heads on
    (1, 4), one a rank, and d_model 32x head_dim, traced with
    ``seq_shard`` on and off: ``fused_flash_bytes`` leaves out the
    attention scores [B*H_local, S, T] = [1, 512, 512] alone, the same bytes on and off, so the two differ only as their
    fused bytes do (the collectives); no residual, norm or ``wo`` bytes
    are left out (the score rule once took ``wo``'s row-parallel product
    for a score)."""
    r = _python(_ONE_HEAD)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    on, off = rows["True"], rows["False"]
    for row in (on, off):
        assert row["left_out"], row
        for shape, _ in row["left_out"]:
            assert shape == [1, 512, 512], row["left_out"]
        assert row["fused_bytes"] - row["fused_flash_bytes"] == sum(
            n for _, n in row["left_out"]), row
    assert (on["fused_bytes"] - on["fused_flash_bytes"]
            == off["fused_bytes"] - off["fused_flash_bytes"]), rows


_SAVE_MOE = """
import json
import repro_torch.launch.lowering as low
from repro_torch.launch.mesh import fake_world, make_test_mesh
from tests.test_torch_dryrun_small import _patch_small
from repro_torch.configs.base import ShapeConfig
fake_world(2)
_patch_small(low)
# long enough that the kept activations outweigh the optimizer's peak
low.SHAPES["train_4k"] = ShapeConfig("train_4k", 1024, 4, "train")
mesh = make_test_mesh((1, 2), ("data", "model"), "meta")
rows = {}
for remat in (True, "save_moe"):
    row = low.lower_and_analyze(dict(arch="llama4-scout-17b-a16e",
                                     shape="train_4k", remat=remat), mesh)
    rows[str(remat)] = {
        "temp": row["memory_analysis"]["temp_size_in_bytes"],
        "ag": row["collectives"]["all-gather_count"],
        "ar": row["collectives"]["all-reduce_count"]}
print(json.dumps(rows))
"""


def test_save_moe_traces_more_temp_bytes_and_fewer_all_gathers():
    """A (1, 2) reduced llama4-scout train cell of 4 x 1024 (4 MoE
    layers, the experts split over ep) under ``remat="save_moe"``: more temp bytes a
    rank than full remat (each MoE layer's boundary tensors kept) and
    one all-gather fewer a MoE layer (the backward does not gather the
    expert output again); the all-reduces as many."""
    r = _python(_SAVE_MOE)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    full, sel = rows["True"], rows["save_moe"]
    n_moe = _small_config("llama4-scout-17b-a16e").n_layers
    assert sel["temp"] > full["temp"], rows
    assert full["ag"] - sel["ag"] == n_moe, rows
    assert sel["ar"] == full["ar"], rows


def test_cp_decode_cell_traces_the_merge_and_equals_a_real_run():
    """A long_500k cell (batch 1; here 32 slots) of reduced gemma3-12b on
    (data 2, model 1): the batch is replicated, the cache split over
    kvseq, and each of its six attention layers merges with two
    all-reduces over the data ranks, traced on meta as run on two gloo
    ranks."""
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        traced = ex.submit(_traced, "gemma3-12b", "long_500k",
                           (2, 1)).result(timeout=TIMEOUT)
    real = spawn(_gloo_rank, 2, "gemma3-12b", "long_500k", (2, 1),
                 timeout=TIMEOUT)
    merges = [r for r in traced if r[3].startswith("models.layers._cp_decode")]
    assert len(merges) == 2 * 6, traced
    assert all(r[0] == "all_reduce" and r[2] == (0, 1) for r in merges)
    assert traced == real[0], (len(traced), len(real[0]))


def _mamba_cell(tp):
    """A reduced jamba prefill cell of one rank of a ``fake`` world of
    ``tp`` ranks on (data 1, model tp), traced: its row's keys, and its
    Mamba params' bytes on this rank, as the trace holds them, beside
    the whole leaves' bytes (those with an ``ssm_inner`` dim, and the
    rest)."""
    import math
    import torch
    import repro_torch.launch.lowering as low
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    fake_world(tp)
    _patch_small(low)
    mesh = make_test_mesh((1, tp), ("data", "model"), "meta")
    row = low.lower_and_analyze(dict(arch="jamba-v0.1-52b",
                                     shape="prefill_32k"), mesh)
    cell = low.build_cell("jamba-v0.1-52b", "prefill_32k", mesh)
    params = cell.args[0]["stack"]
    dims = low.build_model(cell.cfg).param_dims()["stack"]
    local = split = whole = 0
    for name, leaf in ((b, k) for b in params if "mamba" in b
                       for k in params[b]):
        dt, d = params[name][leaf], dims[name][leaf]
        t = dt.to_local()
        assert t.device == torch.device("meta")
        local += t.numel() * t.element_size()
        n = math.prod(dt.shape) * t.element_size()
        if "ssm_inner" in d:
            split += n
        else:
            whole += n
    return sorted(row), local, split, whole


@pytest.mark.parametrize("tp", [2, 4])
def test_a_jamba_cell_holds_a_model_rank_share_of_its_mamba_params(tp):
    """The Mamba blocks split over the model axis: a traced reduced jamba
    cell holds 1/tp of every Mamba leaf with an ``ssm_inner`` dim (the
    rest, ``ssm_inner_nt`` and the norm, whole), and its row names no
    block kind left unsplit."""
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        keys, local, split, whole = ex.submit(_mamba_cell, tp).result(
            timeout=TIMEOUT)
    assert "tp_replicated" not in keys and "memory_analysis" in keys, keys
    assert split % tp == 0 and split > 4 * whole, (split, whole)
    assert local == split // tp + whole, (local, split, whole)


_MESHES = """
import torch.distributed as dist
from repro_torch.launch.mesh import fake_world, make_production_mesh
fake_world(128)
try:
    make_production_mesh(device_type="meta")
except RuntimeError as e:
    print("REFUSED", "need 256 ranks" in str(e))
dist.destroy_process_group()
fake_world(512, rank=300)
m = make_production_mesh(multi_pod=True, device_type="meta")
print("MESH", tuple(m.shape), m.mesh_dim_names, tuple(m.get_coordinate()))
m = make_production_mesh(device_type="meta")
print("MESH", tuple(m.shape), m.mesh_dim_names, m.get_coordinate())
"""


def test_production_meshes_in_a_fake_world():
    r = _python(_MESHES)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "REFUSED True"
    assert lines[1] == ("MESH (2, 16, 16) ('pod', 'data', 'model') "
                        "(1, 2, 12)")
    assert lines[2] == "MESH (16, 16) ('data', 'model') None"


_BF16_AR = """
import torch
from repro_torch.launch import analysis
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.sharding import specs as SH
fake_world(4)
mesh = make_test_mesh((1, 4), ("data", "model"), "meta")
with SH.activation_sharding(SH.make_axes(mesh), mesh), \\
        SH.collective_log() as log:
    SH.tp_all_reduce(torch.empty(256, dtype=torch.bfloat16, device="meta"))
    SH.gather_from_tp(torch.empty(8, 3, device="meta"), 1)
print(log[0]["group"], log[0]["dtype"], log[1]["kind"], log[1]["bytes"])
print(analysis.collective_bytes(log)["all-reduce_bytes"])
"""


def test_a_bf16_all_reduce_counts_at_bf16_width():
    r = _python(_BF16_AR)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == f"model bfloat16 all_gather {8 * 12 * 4}"
    assert lines[1] == str(256 * 2)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], capture_output=True, text=True,
                          timeout=TIMEOUT, env=_env(), cwd=str(ROOT))


@pytest.fixture(scope="module")
def cli_row(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = _cli("--arch", "seamless-m4t-medium", "--shape", "decode_32k",
             "--out", str(out))
    assert r.returncode == 0, r.stderr[-3000:]
    path = out / "seamless-m4t-medium_decode_32k_16x16.json"
    return json.loads(path.read_text()), r.stdout


def test_dryrun_cli_writes_the_reference_keys(cli_row):
    row, stdout = cli_row
    for k in ("arch", "shape", "mesh", "n_chips", "params", "active_params",
              "n_groups", "kind", "memory_analysis", "flops_per_device",
              "bytes_per_device", "collectives", "roofline"):
        assert k in row, k
    assert row["mesh"] == "16x16" and row["n_chips"] == 256
    assert row["kind"] == "decode"
    # 16 kv heads, one a rank: the decode kernel on each of the 12
    # layers' self- and cross-attention
    assert row["kernel_calls"] == {"decode_attention": 24}, row
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "memory_flash_s", "step_bound_s", "useful_flops_ratio"):
        assert k in row["roofline"], k
    assert "roofline:" in stdout


def test_report_renders_a_dryrun_row(cli_row):
    from repro_torch.launch import report
    row, _ = cli_row
    dr = report.dryrun_table([row])
    assert "| seamless-m4t-medium | decode_32k | 16x16 |" in dr
    assert "OK" in dr
    ro = report.roofline_table([row])
    assert "| seamless-m4t-medium | decode_32k |" in ro
    assert f"**{row['roofline']['dominant_flash']}**" in ro


def test_dryrun_cli_traces_a_batch_the_data_axis_does_not_divide(tmp_path):
    """long_500k's batch of 1 is replicated over the 16 data ranks (xLSTM:
    no KV cache to split over kvseq) and the cell writes its row."""
    r = _cli("--arch", "xlstm-125m", "--shape", "long_500k",
             "--out", str(tmp_path))
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    row = json.loads((tmp_path / "xlstm-125m_long_500k_16x16.json")
                     .read_text())
    assert row["kind"] == "decode" and row["shape"] == "long_500k"
    assert row["memory_analysis"]["argument_size_in_bytes"] > 0


def test_dryrun_cli_shards_a_train_cell_over_the_sequence(tmp_path):
    """internlm2-1.8b train_4k at full size on (16, 16): the default is
    ``seq_shard`` on, recorded in the row, and a rank's argument and temp
    bytes fall below the same cell's with ``--seq-shard off`` (12.5 GB
    there, PERF.md's dry-run table before the split)."""
    live, rs = {}, {}
    for flag in ("on", "off"):
        args = ("--arch", "internlm2-1.8b", "--shape", "train_4k",
                "--out", str(tmp_path / flag))
        r = _cli(*args) if flag == "on" else _cli(*args, "--seq-shard",
                                                  "off")
        assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
        row = json.loads((tmp_path / flag / "internlm2-1.8b_train_4k_16x16"
                          ".json").read_text())
        assert row["seq_shard"] is (flag == "on"), row["seq_shard"]
        ma = row["memory_analysis"]
        live[flag] = (ma["argument_size_in_bytes"]
                      + ma["temp_size_in_bytes"])
        rs[flag] = row["collectives"]["reduce-scatter_count"]
    assert rs["on"] > 0 and rs["off"] == 0, rs
    assert live["on"] < live["off"] and live["on"] < 12.5e9, live


def test_dryrun_cli_skips_long_500k_of_a_quadratic_arch(tmp_path):
    r = _cli("--arch", "internlm2-1.8b", "--shape", "long_500k",
             "--out", str(tmp_path))
    assert r.returncode == 3, (r.stdout, r.stderr[-2000:])
    assert "pure full-attention arch" in r.stdout
    assert not list(tmp_path.iterdir())


def test_inject_tables(tmp_path, monkeypatch, cli_row):
    from repro_torch.launch import inject_tables
    row, _ = cli_row
    for d in ("dryrun", "dryrun_v2"):
        (tmp_path / "experiments" / d).mkdir(parents=True)
        (tmp_path / "experiments" / d / "a.json").write_text(json.dumps(row))
    (tmp_path / "EXPERIMENTS.md").write_text(
        "# E\n<!-- DRYRUN_TABLE -->\n<!-- ROOFLINE_TABLE -->\n"
        "<!-- PICK_NOTE -->\n")
    monkeypatch.chdir(tmp_path)
    inject_tables.main()
    text = (tmp_path / "EXPERIMENTS.md").read_text()
    assert "<!--" not in text
    assert "| seamless-m4t-medium | decode_32k | 16x16 |" in text
    assert "worst roofline fraction: seamless-m4t-medium/decode_32k" in text
