"""The expert split of the forward on eight gloo CPU ranks
(``launch.mesh.spawn``), f32, reduced configs, against the port's
one-process step:

  * the port of the JAX package's
    ``test_dryrun_small.py::test_small_mesh_sharded_train_step_runs``:
    reduced llama4-scout-17b-a16e on mesh (data 2, model 4) with FSDP,
    two steps from the pipeline: the loss finite and within 1e-4 of one
    process's, every gradient of the first step within rtol 1e-4 / atol
    1e-6 plus 1e-5 of its leaf's largest entry; ``we_u``'s DTensor placements shard ``experts`` over ``model``
    and each rank holds one of the four experts;
  * reduced jamba-v0.1-52b on the same mesh: its MoE and attention
    blocks split, its Mamba blocks whole on every model rank, the loss
    and gradients within the same tolerances.

Bit equality is not asked for: the split reduces in another order than
one process.
"""
import dataclasses

import pytest
from torch.distributed.tensor import Shard

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.launch.mesh import spawn
from tests.test_torch_tp import RANK_TIMEOUT, train_against_one_process

SHAPE = (2, 4)
# the embedding's gradient sums every position of a token, split over the
# data ranks here: an entry that sums to ~0 keeps f32 rounding of its
# parts (jamba: 6.8e-6 on an entry of a leaf whose largest is 1.57), so
# gradients are also allowed 1e-5 of their leaf's largest entry
LEAF_RTOL = 1e-5
ARCHS = ("llama4-scout-17b-a16e", "jamba-v0.1-52b")


def _moe_rank(rank, world):
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        model = build_model(cfg)
        res, st = train_against_one_process(
            model, SHAPE, TokenPipeline(cfg, 4, 32, seed=0).next("cpu"),
            use_fsdp=True, steps=2, leaf_rtol=LEAF_RTOL)
        moe = next(b.name for b in model.blocks if b.kind == "moe")
        we = st["params"]["stack"][moe]["we_u"]
        res["we_u"] = (tuple(we.placements), tuple(we.to_local().shape),
                       tuple(we.shape))
        out[arch] = res
    return out


@pytest.fixture(scope="module")
def moe():
    return spawn(_moe_rank, SHAPE[0] * SHAPE[1], timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_sharded_train_step_runs(moe, arch):
    for r in moe:
        t = r[arch]
        for got, want in zip(t["split"], t["one"]):
            assert got == got and abs(got) < float("inf"), t
            assert abs(got - want) <= 1e-4, (got, want)
        assert t["excess"] <= 0.0, t["excess"]


@pytest.mark.parametrize("arch", ARCHS)
def test_experts_are_sharded_over_model(moe, arch):
    for r in moe:
        placements, local, whole = r[arch]["we_u"]
        # mesh dims (data, model): experts (dim 1 of the stacked leaf)
        # over model; moe_embed (dim 2) over data under FSDP
        assert placements == (Shard(2), Shard(1)), placements
        assert local[1] == whole[1] // SHAPE[1] == 1, (local, whole)
