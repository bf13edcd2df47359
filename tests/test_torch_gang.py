"""The port's gang images against the reference's.

A gang image that the port writes at 4 ranks (int8 and raw) restores
through the port's ``load_gang_ranks`` at 2 ranks to exactly what the
reference's ``load_gang_ranks`` gives on the image the reference writes of
the same values; equal values give equal chunk digests in both packages.
The int8 image holds replicated float leaves stored as one chunk each,
which the port's reader assembles on the host (``_assemble_region``).
"""
import numpy as np
import pytest
import torch

from repro.ckpt import InMemoryStore as JStore
from repro.ckpt.gang import load_gang_ranks as jload
from repro.ckpt.gang import save_gang_image as jsave
from repro.core.gang import GANG_ROUTED, GANG_SHARDED
from repro_torch.ckpt import InMemoryStore as TStore
from repro_torch.ckpt.gang import load_gang_ranks as tload
from repro_torch.ckpt.gang import save_gang_image as tsave
from repro_torch.ckpt.reader import load_manifest
from repro_torch.sharding import even_regions


def _rank_trees(n_ranks, rows=12, inflight=3):
    """Rank trees of one global cut, as tests/test_gang.py builds them,
    plus a replicated f32 table big enough for several int8 blocks."""
    rng = np.random.default_rng(0)
    msgs = [(float(r), float(i), float(rng.integers(rows)), 1.0)
            for r in range(n_ranks) for i in range(inflight)]
    per_rank = np.array(msgs, np.float64).reshape(-1, 4)
    table = (rng.standard_normal((3, 700)) * 4).astype(np.float32)
    trees = []
    for r, (off, length) in enumerate(even_regions(rows, n_ranks)):
        trees.append({"state": rng.random((length, 2)) * 10, "iteration": 7,
                      "inbox": per_rank[r::n_ranks].copy(),
                      "table": table.copy()})
    return trees


def _as_numpy(tree):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_port_gang_image_reshards_like_the_reference(codec):
    trees = _rank_trees(4)
    kw = dict(sharded=GANG_SHARDED, routed=GANG_ROUTED, codec=codec)
    tstore, jstore = TStore(), JStore()
    tsave(tstore, "apps/j", 100, trees, **kw)
    jsave(jstore, "apps/j", 100, trees, **kw)
    ours, man, stats = tload(tstore, "apps/j", n_ranks=2, device="cpu")
    want, _, _ = jload(jstore, "apps/j", n_ranks=2)
    assert len(ours) == len(want) == 2
    for o, w in zip(ours, want):
        assert all(isinstance(o[k], torch.Tensor) and o[k].device.type ==
                   "cpu" for k in ("state", "inbox", "table"))
        o = _as_numpy(o)
        assert set(o) == set(w)
        assert o["iteration"] == w["iteration"] == 7
        for k in ("state", "inbox", "table"):
            assert o[k].dtype == np.asarray(w[k]).dtype
            assert o[k].tobytes() == np.asarray(w[k]).tobytes(), k
    assert stats["chunk_fetches"] == stats["unique_chunks"]
    if codec == "raw":       # lossless: the cut comes back exactly
        full = np.concatenate([t["state"] for t in trees])
        assert np.array_equal(np.concatenate([o["state"].numpy()
                                              for o in ours]), full)
        assert np.array_equal(ours[0]["table"].numpy(), trees[0]["table"])
    # equal values, equal chunk digests, in both packages
    jman = load_manifest(jstore, "apps/j", 100)
    digests = lambda m: {n: sorted(c.hash for c in li.chunks)
                         for n, li in m.leaves.items()}
    assert digests(man) == digests(jman)


def test_reference_gang_image_restores_in_the_port():
    trees = _rank_trees(4)
    store = JStore()
    jsave(store, "apps/j", 100, trees, sharded=GANG_SHARDED,
          routed=GANG_ROUTED, codec="int8")
    for n in (1, 3):
        ours, _, _ = tload(store, "apps/j", n_ranks=n, device="cpu")
        want, _, _ = jload(store, "apps/j", n_ranks=n)
        for o, w in zip(ours, want):
            o = _as_numpy(o)
            for k in ("state", "inbox", "table"):
                assert o[k].tobytes() == np.asarray(w[k]).tobytes(), (n, k)


def test_load_gang_ranks_needs_a_device_or_an_explicit_cpu(monkeypatch):
    store = TStore()
    tsave(store, "apps/j", 1, _rank_trees(2), sharded=GANG_SHARDED,
          routed=GANG_ROUTED)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tload(store, "apps/j")


def test_gang_job_suspends_and_resumes_under_the_port_service():
    """A 4-rank GangApp under the port's service (on its virtual clock):
    the barrier cuts a consistent gang image, the suspended job resumes
    from it onto the CPU it declares, and its ranks go on iterating."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                  CoordState, GangApp, gang_invariant)
    from repro_torch.sim.simtime import SimClock, active_clock, install_clock
    clk = SimClock()
    prev = install_clock(clk)
    svc = CACSService({"snooze": SnoozeBackend(n_hosts=8)},
                      {"default": TStore()})
    try:
        cid = svc.submit(ASR(
            name="gang", n_vms=4, backend="snooze",
            app_factory=lambda: GangApp(global_rows=16, iter_time_s=0.05),
            policy=CheckpointPolicy(period_s=0, keep_last=3), gang=True,
            straggler_action="ignore"))
        svc.wait_for_state(cid, CoordState.RUNNING, 30)
        active_clock().paper_sleep(1.0)
        step = svc.trigger_checkpoint(cid)
        coord = svc.db.get(cid)
        trees, man, _ = svc.ckpt.load_gang(coord, step, n_ranks=4)
        assert man.metadata["gang"]["ranks"] == 4
        assert gang_invariant(trees)["consistent"] == 1.0
        assert trees[0]["state"].device.type == "cpu"
        svc.apps.suspend(cid)
        assert svc.db.get(cid).state == CoordState.SUSPENDED
        svc.apps.resume(cid)
        coord = svc.wait_for_state(cid, CoordState.RUNNING, 30)
        assert coord.app.restarts == 1
        it0 = coord.app.min_iteration()
        active_clock().paper_sleep(1.0)
        assert coord.app.min_iteration() > it0
    finally:
        svc.shutdown()
        clk.close()
        install_clock(prev)
