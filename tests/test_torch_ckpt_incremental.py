"""Incremental content-addressed checkpointing in the port
(``repro_torch.ckpt``): the cases of the JAX package's
``tests/test_ckpt_incremental.py`` on the port's API, each fed the same
numpy values in both packages where both run: dedup on the write path,
mark-and-sweep GC over shared chunks, legacy-manifest compatibility and
end-to-end chunk integrity. The port's writer and reader were changed
for DTensor state, so the copy-drift guard does not cover them; these
cases do. Where the two packages' images meet, a case also restores the
other package's image, or writes its second step on top of the other's
first, and holds the dedup counters (and the chunk keys) equal to the
reference's."""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as J
from repro.ckpt import gc as jgc
from repro_torch.ckpt import (AsyncCheckpointer, InMemoryStore, list_steps,
                              restore, save_checkpoint)
from repro_torch.ckpt import gc as ckpt_gc
from repro_torch.ckpt.layout import (COMMITTED, MANIFEST, cas_prefix,
                                     step_prefix)
from repro_torch.ckpt.reader import load_manifest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(scale=1.0):
    return {"w": np.arange(4096.0, dtype=np.float32) * np.float32(scale),
            "opt": {"m": np.ones(512, np.float32),
                    "v": np.ones(512, np.float32) * 2},
            "step_count": 7}


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    return conv(tree) if isinstance(tree, np.ndarray) else tree


def _tree(scale=1.0):
    return _to(_np_tree(scale), torch.from_numpy)


def _jtree(scale=1.0):
    return _to(_np_tree(scale), jnp.asarray)


def _restore(store, prefix, step=None):
    return restore(store, prefix, step, device="cpu")


def test_identical_resave_writes_only_manifest_and_marker():
    store = InMemoryStore()
    save_checkpoint(store, "p", 1, _tree())
    puts_before = store.put_count
    bytes_before = store.bytes_in
    man = save_checkpoint(store, "p", 2, _tree())
    # exactly MANIFEST.json + COMMITTED — zero data chunks
    assert store.put_count - puts_before == 2
    keys_written = {k for k in store.list(step_prefix("p", 2))}
    assert keys_written == {f"{step_prefix('p', 2)}/{MANIFEST}",
                            f"{step_prefix('p', 2)}/{COMMITTED}"}
    dd = man.metadata["dedup"]
    assert dd["bytes_written"] == 0
    assert dd["dedup_misses"] == 0
    assert dd["dedup_hits"] == dd["chunks"] == 4
    assert store.bytes_in - bytes_before < dd["bytes_deduped"] / 4
    out, _ = _restore(store, "p", 2)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))
    # the reference's resave of the same values over the port's step 1
    # writes no chunk either, and its counters are the port's
    jman = J.save_checkpoint(store, "p", 3, _jtree())
    assert jman.metadata["dedup"] == dd


def test_partial_update_writes_only_dirty_chunks():
    store = InMemoryStore()
    save_checkpoint(store, "p", 1, _tree())
    t = _tree()
    t["opt"]["m"] = torch.ones(512) * 3              # dirty exactly one leaf
    man = save_checkpoint(store, "p", 2, t)
    dd = man.metadata["dedup"]
    assert dd["dedup_misses"] == 1
    assert dd["dedup_hits"] == 3
    assert dd["bytes_written"] == 512 * 4
    out, _ = _restore(store, "p", 2)
    np.testing.assert_array_equal(out["opt"]["m"].numpy(),
                                  np.full(512, 3.0, np.float32))
    out1, _ = _restore(store, "p", 1)
    np.testing.assert_array_equal(out1["opt"]["m"].numpy(),
                                  np.ones(512, np.float32))
    # the same two saves in the reference: the same counters, and its
    # reader restores the port's step 2
    jstore = J.InMemoryStore()
    J.save_checkpoint(jstore, "p", 1, _jtree())
    jt = _jtree()
    jt["opt"]["m"] = jnp.ones(512) * 3
    assert J.save_checkpoint(jstore, "p", 2, jt).metadata["dedup"] == dd
    jout, _ = J.restore(store, "p", 2)
    np.testing.assert_array_equal(np.asarray(jout["opt"]["m"]),
                                  np.full(512, 3.0, np.float32))


def test_identical_leaves_share_one_chunk():
    store = InMemoryStore()
    man = save_checkpoint(store, "p", 1,
                          {"a": torch.ones(256), "b": torch.ones(256)})
    assert man.leaves["a"].chunks[0].key == man.leaves["b"].chunks[0].key
    assert man.metadata["dedup"]["dedup_misses"] == 1
    jman = J.save_checkpoint(J.InMemoryStore(), "p", 1,
                             {"a": jnp.ones(256), "b": jnp.ones(256)})
    assert jman.leaves["a"].chunks[0].key == man.leaves["a"].chunks[0].key


def test_gc_keeps_shared_chunks_and_sweeps_orphans():
    store = InMemoryStore()
    save_checkpoint(store, "p", 1, _tree())        # w, m, v, step_count
    t2 = _tree()
    t2["opt"]["m"] = torch.ones(512) * 9           # new chunk at step 2
    save_checkpoint(store, "p", 2, t2)
    n_cas = len(store.list(cas_prefix("p")))
    deleted = ckpt_gc.collect(store, "p", keep_last=1)
    assert deleted == [1]
    assert len(store.list(cas_prefix("p"))) == n_cas - 1
    assert list_steps(store, "p") == [2]
    out, _ = _restore(store, "p")
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))
    np.testing.assert_array_equal(out["opt"]["m"].numpy(),
                                  np.full(512, 9.0, np.float32))
    assert ckpt_gc.sweep_orphans(store, "p") == []
    # the reference's GC finds nothing left to sweep in the port's image
    assert jgc.sweep_orphans(store, "p") == []


def test_gc_refcount_shared_across_retained_steps():
    store = InMemoryStore()
    for s in (1, 2, 3):
        save_checkpoint(store, "p", s, _tree())    # all steps share chunks
    ckpt_gc.collect(store, "p", keep_last=2)       # drops step 1 only
    for s in (2, 3):
        out, _ = _restore(store, "p", s)
        np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))
        jout, _ = J.restore(store, "p", s)
        np.testing.assert_array_equal(np.asarray(jout["w"]),
                                      np.arange(4096.0))


def test_legacy_full_save_still_works_and_loads():
    store = InMemoryStore()
    man = save_checkpoint(store, "p", 1, _tree(), incremental=False)
    assert man.version == 1
    assert all(c.hash is None for li in man.leaves.values()
               for c in li.chunks)
    assert not store.list(cas_prefix("p"))         # chunks live in step dir
    out, _ = _restore(store, "p")
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))
    man2 = save_checkpoint(store, "p", 2, _tree())
    assert man2.metadata["dedup"]["dedup_misses"] == 4
    # a legacy image of the reference loads in the port
    jstore = J.InMemoryStore()
    J.save_checkpoint(jstore, "p", 1, _jtree(), incremental=False)
    out, _ = _restore(jstore, "p")
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))


def test_pre_hash_manifest_json_loads():
    """Manifests written before ChunkInfo.hash / Manifest.version exist,
    from the port's legacy save and from the reference's."""
    for save in (save_checkpoint, J.save_checkpoint):
        store = InMemoryStore()
        x = (torch.arange(16.0) if save is save_checkpoint
             else jnp.arange(16.0))
        save(store, "p", 1, {"x": x}, incremental=False)
        sp = step_prefix("p", 1)
        d = json.loads(store.get(f"{sp}/{MANIFEST}").decode())
        del d["version"]
        for li in d["leaves"].values():
            for c in li["chunks"]:
                del c["hash"]
        store.put(f"{sp}/{MANIFEST}", json.dumps(d).encode())
        man = load_manifest(store, "p", 1)
        assert man.version == 1
        assert man.leaves["x"].chunks[0].hash is None
        out, _ = _restore(store, "p")
        np.testing.assert_array_equal(out["x"].numpy(), np.arange(16.0))


def test_corrupt_chunk_detected_by_digest():
    for save, x in ((save_checkpoint, torch.arange(16.0)),
                    (J.save_checkpoint, jnp.arange(16.0))):
        store = InMemoryStore()
        man = save(store, "p", 1, {"x": x})
        key = man.leaves["x"].chunks[0].key
        store.put(key, store.get(key)[:-4] + b"\x00\x00\x00\x00")
        with pytest.raises(ValueError, match="digest mismatch"):
            _restore(store, "p")


def test_async_checkpointer_dedup_counters_and_cache():
    store = InMemoryStore()
    ck = AsyncCheckpointer(store, "p", codec="zlib")
    tree = _tree()
    ck.save(1, tree)
    ck.wait()
    puts_after_first = store.put_count
    for s in (2, 3):
        ck.save(s, tree)
    ck.wait()
    st = ck.stats()
    assert st["dedup_hits"] == 8                   # 4 chunks x 2 resaves
    assert store.put_count - puts_after_first == 4
    assert store.dedup_hits == 0                   # the raw cache served
    ck.close()
    for s in (1, 2, 3):
        out, _ = _restore(store, "p", s)
        np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))
    # the reference's checkpointer on the same values counts the same
    jstore = J.InMemoryStore()
    jck = J.AsyncCheckpointer(jstore, "p", codec="zlib")
    for s in (1, 2, 3):
        jck.save(s, _jtree())
    jck.wait()
    assert {k: jck.stats()[k] for k in ("dedup_hits", "dedup_misses")} == \
        {k: st[k] for k in ("dedup_hits", "dedup_misses")}
    jck.close()
    assert jstore.put_count == store.put_count


def test_async_cache_survives_gc_of_old_steps():
    """A chunk swept by GC must not be served from a stale writer cache."""
    store = InMemoryStore()
    ck = AsyncCheckpointer(store, "p")
    a, b = {"x": torch.ones(256)}, {"x": torch.ones(256) * 2}

    def on_commit(_step):
        ckpt_gc.collect(store, "p", keep_last=1)
    ck.save(1, a, on_commit=on_commit)
    ck.save(2, b, on_commit=on_commit)             # GC sweeps step 1's chunk
    ck.save(3, a, on_commit=on_commit)             # content of step 1 returns
    ck.wait()
    out, _ = _restore(store, "p", 3)
    np.testing.assert_array_equal(out["x"].numpy(), np.ones(256, np.float32))
    jout, _ = J.restore(store, "p", 3)
    np.testing.assert_array_equal(np.asarray(jout["x"]),
                                  np.ones(256, np.float32))
    ck.close()


def test_delete_image_invalidates_writer_dedup_cache():
    """CheckpointManager.delete_image sweeps shared chunks; a later save of
    the same content must re-upload them, not dedup against reaped keys.
    The port's manager restores onto the device its app declares."""
    from repro_torch.core.checkpoint_manager import CheckpointManager

    store = InMemoryStore()
    mgr = CheckpointManager({"default": store})
    coord = SimpleNamespace(
        coord_id="c1", ckpt_prefix="p",
        app=SimpleNamespace(device=torch.device("cpu")),
        asr=SimpleNamespace(name="app", policy=SimpleNamespace(
            store="default", codec="raw", keep_last=0, keep_every=0)))
    tree = {"x": torch.ones(256)}
    mgr.save(coord, 1, tree, blocking=False)
    mgr.wait(coord)
    mgr.delete_image(coord, 1)                     # sweeps x's only chunk
    assert store.list(cas_prefix("p")) == []
    mgr.save(coord, 2, tree, blocking=False)       # same content returns
    mgr.wait(coord)
    out = mgr.load(coord, 2)
    np.testing.assert_array_equal(out["x"].numpy(), np.ones(256, np.float32))
    assert out["x"].device.type == "cpu"
    mgr.delete_all(coord)


def test_cross_prefix_clone_dedups_on_ingest():
    """upload_image-style copy: chunk resolution goes through the
    manifest; a reference image cloned the same way restores in the
    port."""
    for save, tree in ((save_checkpoint, _tree()),
                       (J.save_checkpoint, _jtree())):
        src = InMemoryStore()
        save(src, "a", 1, tree)
        man = load_manifest(src, "a", 1)
        dst = InMemoryStore()
        for key in man.chunk_refs():
            dst.put_if_absent("b" + key[len("a"):], src.get(key))
        sp = step_prefix("b", 1)
        dst.put(f"{sp}/{MANIFEST}",
                man.to_json().replace("a/", "b/").encode())
        dst.put(f"{sp}/{COMMITTED}", b"1")
        out, _ = _restore(dst, "b")
        np.testing.assert_array_equal(out["w"].numpy(), np.arange(4096.0))
