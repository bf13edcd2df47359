"""The port's parallel data plane (``repro_torch.ckpt``): the cases of the
JAX package's ``tests/test_ckpt_parallel.py`` on the port's API —
crash-safety, dedup determinism and bit-identical round-trips under
concurrency (writer and reader worker pools, multi-stream two-tier
replication, atomic ``put_if_absent``, single-flight restore,
back-pressure). The port's writer and reader were changed for DTensor
state, so the copy-drift guard does not cover them; these cases do.
Each case takes the same numpy values in both packages where both run:
the reference's save of them gives the port's chunk keys and counters,
and where the images meet the other package restores the port's (or the
port the other's)."""
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as J
from repro_torch.ckpt import (AsyncCheckpointer, DataPlaneConfig,
                              InMemoryStore, TwoTierStore, restore,
                              save_checkpoint)
from repro_torch.ckpt.layout import COMMITTED, MANIFEST, cas_prefix, step_prefix

PAR = DataPlaneConfig.with_workers(8)
JPAR = J.DataPlaneConfig.with_workers(8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(seed: int, n_leaves: int = 12, n: int = 2048):
    rng = np.random.Generator(np.random.PCG64(seed))
    return {f"leaf{i:02d}": rng.standard_normal(n).astype(np.float32)
            for i in range(n_leaves)}


def _tree(seed: int, n_leaves: int = 12, n: int = 2048):
    return {k: torch.from_numpy(v)
            for k, v in _np_tree(seed, n_leaves, n).items()}


def _jtree(seed: int, n_leaves: int = 12, n: int = 2048):
    return {k: jnp.asarray(v) for k, v in _np_tree(seed, n_leaves, n).items()}


def _restore(store, prefix, step=None, plane=PAR):
    return restore(store, prefix, step, plane=plane, device="cpu")


def _equal(out, tree):
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(v))


class OrderedStore(InMemoryStore):
    """Records the completion order of puts (for commit-protocol checks)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.put_order = []

    def put(self, key, data):
        super().put(key, data)
        with self._lock:
            self.put_order.append(key)


def test_parallel_roundtrip_bit_identical():
    tree = _tree(0)
    store = InMemoryStore(latency_s=0.001)
    man = save_checkpoint(store, "p", 1, tree, plane=PAR)
    out, _ = _restore(store, "p")
    _equal(out, tree)
    # the reference's parallel save of the same values: the same chunks
    jman = J.save_checkpoint(J.InMemoryStore(), "p", 1, _jtree(0),
                             plane=JPAR)
    assert [c.key for li in jman.leaves.values() for c in li.chunks] == \
        [c.key for li in man.leaves.values() for c in li.chunks]
    jout, _ = J.restore(store, "p", plane=JPAR)
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(jout[k]), v.numpy())


def test_committed_never_precedes_referenced_chunks():
    """Crash-safety under parallelism: every chunk a manifest references is
    durable before the manifest, which lands before COMMITTED."""
    tree = _tree(1, n_leaves=24)
    store = OrderedStore(latency_s=0.0005)
    man = save_checkpoint(store, "p", 1, tree, plane=PAR)
    order = {k: i for i, k in enumerate(store.put_order)}
    man_at = order[f"{step_prefix('p', 1)}/{MANIFEST}"]
    com_at = order[f"{step_prefix('p', 1)}/{COMMITTED}"]
    assert com_at == len(store.put_order) - 1
    assert man_at == com_at - 1
    for li in man.leaves.values():
        for c in li.chunks:
            assert order[c.key] < man_at, f"chunk {c.key} after manifest"


def test_parallel_dedup_counters_deterministic():
    """Identical content across leaves collapses to one put no matter how
    8 workers race: single-flight + atomic put_if_absent."""
    same = np.full(4096, 3.25, np.float32)
    store = InMemoryStore()
    man = save_checkpoint(store, "p", 1,
                          {f"dup{i}": torch.from_numpy(same)
                           for i in range(16)}, plane=PAR)
    dd = man.metadata["dedup"]
    assert dd["chunks"] == 16
    assert dd["dedup_misses"] == 1
    assert dd["dedup_hits"] == 15
    assert dd["bytes_written"] == 4096 * 4
    assert len(store.list(cas_prefix("p"))) == 1
    assert store.dedup_misses == 1
    jman = J.save_checkpoint(J.InMemoryStore(), "p", 1,
                             {f"dup{i}": jnp.asarray(same)
                              for i in range(16)}, plane=JPAR)
    assert jman.metadata["dedup"] == dd


def test_workers1_reproduces_serial_plane():
    tree = _tree(2)
    serial = InMemoryStore()
    par = InMemoryStore()
    m1 = save_checkpoint(serial, "p", 1, tree,
                         plane=DataPlaneConfig.serial())
    m2 = save_checkpoint(par, "p", 1, tree, plane=PAR)
    assert m1.metadata["dedup"] == {**m2.metadata["dedup"]}
    assert serial.put_count == par.put_count
    assert serial.list("") == par.list("")
    assert serial.total_bytes(cas_prefix("p")) == \
        par.total_bytes(cas_prefix("p"))
    # and the reference's serial plane writes the same keys
    jserial = InMemoryStore()
    J.save_checkpoint(jserial, "p", 1, _jtree(2),
                      plane=J.DataPlaneConfig.serial())
    assert jserial.list("") == serial.list("")


def test_backpressure_tiny_budget_still_correct():
    """max_inflight_bytes smaller than one chunk: pipeline degrades to
    near-serial admission but must not deadlock or corrupt."""
    tree = _tree(3, n_leaves=8)
    plane = DataPlaneConfig(encode_workers=2, upload_workers=4,
                            max_inflight_bytes=1024)        # < one chunk
    store = InMemoryStore()
    save_checkpoint(store, "p", 1, tree, plane=plane)
    out, _ = _restore(store, "p", plane=plane)
    _equal(out, tree)


def test_concurrent_saves_and_restore_shared_link():
    """Stress: three writers on distinct prefixes + a reader, all through
    one shared-bandwidth store (the paper's contended NFS ingress)."""
    store = InMemoryStore(bandwidth_bps=2e9, shared_link=True)
    trees = {f"app{i}": _tree(10 + i, n_leaves=6) for i in range(3)}
    for name, tree in trees.items():        # step 1 exists for the reader
        save_checkpoint(store, name, 1, tree, plane=PAR)
    errors = []

    def writer(name, tree):
        try:
            for step in (2, 3):
                save_checkpoint(store, name, step, tree, plane=PAR)
        except BaseException as e:          # pragma: no cover
            errors.append(e)

    def reader(name, tree):
        try:
            for _ in range(4):
                out, _ = _restore(store, name, 1)
                _equal(out, tree)
        except BaseException as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(n, t))
               for n, t in trees.items()]
    threads += [threading.Thread(target=reader, args=(n, t))
                for n, t in trees.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    for name, tree in trees.items():        # every committed step restores
        for step in (1, 2, 3):
            out, _ = _restore(store, name, step)
            _equal(out, tree)


def test_put_if_absent_atomic_under_race():
    store = InMemoryStore(latency_s=0.002)
    data = b"z" * 4096
    results = []

    def race():
        results.append(store.put_if_absent("k", data))

    threads = [threading.Thread(target=race) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results.count(True) == 1         # exactly one writer
    assert store.put_count == 1             # and exactly one store write
    assert store.dedup_misses == 1
    assert store.dedup_hits == 7


def test_restore_single_flight_shared_chunk_fetched_once():
    same = np.arange(2048.0, dtype=np.float32)
    for save, leaf in ((save_checkpoint, torch.from_numpy(same)),
                       (J.save_checkpoint, jnp.asarray(same))):
        store = InMemoryStore()
        save(store, "p", 1, {f"dup{i}": leaf for i in range(8)},
             plane=PAR if save is save_checkpoint else JPAR)
        store.get_count = 0
        out, _ = _restore(store, "p")
        # 1 manifest get + exactly 1 fetch of the single shared CAS chunk
        assert store.get_count == 2
        for k in out:
            np.testing.assert_array_equal(out[k].numpy(), same)


def test_restore_tiny_prefetch_window_no_duplicate_fetches():
    """With a prefetch window smaller than one chunk, assembly overtakes
    the queue and force-submits; stale queue entries must not be
    resubmitted after release (regression: double-fetch + window leak)."""
    tree = {f"leaf{i}": torch.full((512,), float(i + 1)) for i in range(8)}
    tree["dupA"] = tree["dupB"] = torch.full((512,), -1.0)
    store = InMemoryStore()
    save_checkpoint(store, "p", 1, tree, plane=PAR)
    store.get_count = 0
    plane = DataPlaneConfig(fetch_workers=4, max_inflight_bytes=1)
    out, _ = _restore(store, "p", plane=plane)
    # 1 manifest get + exactly one fetch per distinct decode (9)
    assert store.get_count == 10
    _equal(out, tree)


def test_restore_same_bytes_different_shape_and_dtype():
    """Byte-identical chunks shared by leaves of different shape/dtype map
    to ONE CAS key but distinct decodes — the restore cache must not hand
    one leaf's decode to another."""
    tree = {"flat": torch.zeros(1024, dtype=torch.float32),
            "grid": torch.zeros((32, 32), dtype=torch.float32),
            "ints": torch.zeros(1024, dtype=torch.int32)}  # same 4096 bytes
    store = InMemoryStore()
    man = save_checkpoint(store, "p", 1, tree, plane=PAR)
    keys = {li.chunks[0].key for li in man.leaves.values()}
    assert len(keys) == 1                           # truly one shared chunk
    out, _ = _restore(store, "p")
    assert tuple(out["flat"].shape) == (1024,)
    assert tuple(out["grid"].shape) == (32, 32)
    assert out["ints"].dtype == torch.int32
    _equal(out, tree)
    # the reference's reader keeps them apart in the port's image too
    jout, _ = J.restore(store, "p", plane=JPAR)
    assert np.asarray(jout["grid"]).shape == (32, 32)
    assert np.asarray(jout["ints"]).dtype == np.int32


def test_two_tier_multistream_durability_and_flush():
    local = InMemoryStore()
    remote = InMemoryStore(latency_s=0.001)
    tt = TwoTierStore(local, remote, upload_streams=4)
    tree = _tree(4)
    save_checkpoint(tt, "p", 1, tree, plane=PAR)    # flush()es inside
    assert tt.pending_uploads() == 0                # condition-var drain
    tt.drop_local()                                 # host loses fast tier
    out, _ = _restore(tt, "p")
    _equal(out, tree)
    tt.close()
    # the remote tier alone holds a whole image, which the reference reads
    jout, _ = J.restore(remote, "p", plane=JPAR)
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(jout[k]), v.numpy())


def test_two_tier_flush_surfaces_upload_error():
    class FailingRemote(InMemoryStore):
        def __init__(self):
            super().__init__()
            self.failed = False

        def put(self, key, data):
            if not self.failed and key.endswith("boom"):
                self.failed = True
                raise IOError("remote down")
            super().put(key, data)

    remote = FailingRemote()
    tt = TwoTierStore(InMemoryStore(), remote, upload_streams=3)
    tt.put("x/boom", b"1")
    with pytest.raises(IOError, match="remote down"):
        tt.flush()                      # surfaces the error AND re-queues
    tt.flush()                          # transient failure healed …
    assert remote.exists("x/boom")      # … and the chunk IS remote now
    tt.close()


def test_blocking_save_gc_serialized_with_async_writer():
    """A blocking save (+ its GC sweep) on a prefix with an async writer
    must run AFTER any in-flight async save: sweeping concurrently would
    reap chunks the in-flight save has put but not yet committed, then
    commit a manifest pointing at reaped keys."""
    from repro_torch.ckpt import list_steps
    from repro_torch.core.checkpoint_manager import CheckpointManager

    store = InMemoryStore(latency_s=0.001)
    mgr = CheckpointManager({"default": store}, plane=PAR)
    coord = SimpleNamespace(
        coord_id="c1", ckpt_prefix="p",
        app=SimpleNamespace(device=torch.device("cpu")),
        asr=SimpleNamespace(name="app", policy=SimpleNamespace(
            store="default", codec="raw", keep_last=2, keep_every=0,
            plane=None)))
    trees = {s: _tree(100 + s, n_leaves=6) for s in (1, 2, 3, 4)}
    for s in (1, 2):
        mgr.save(coord, s, trees[s], blocking=False)
    mgr.save(coord, 3, trees[3], blocking=False)   # in flight on slow store
    mgr.save(coord, 4, trees[4], blocking=True)    # + GC(keep_last=2)
    mgr.wait(coord)
    steps = list_steps(store, "p")
    assert steps and steps[-1] == 4
    for s in steps:                                # every committed step
        out, _ = _restore(store, "p", s)           # must fully restore
        _equal(out, trees[s])
    mgr.delete_all(coord)


def test_async_checkpointer_parallel_counters_and_gc():
    from repro_torch.ckpt import gc as ckpt_gc
    store = InMemoryStore()
    ck = AsyncCheckpointer(store, "p", plane=PAR)
    tree = _tree(5, n_leaves=8)

    def on_commit(_step):
        ckpt_gc.collect(store, "p", keep_last=2)
    for s in (1, 2, 3):
        ck.save(s, tree, on_commit=on_commit)
    ck.wait()
    st = ck.stats()
    assert st["dedup_misses"] == 8                  # first save only
    assert st["dedup_hits"] == 16                   # 8 chunks x 2 resaves
    for s in (2, 3):
        out, _ = _restore(store, "p", s)
        _equal(out, tree)
    ck.close()
