"""Checkpoint images interchange between the JAX package and the port.

Both write MANIFEST v2, ``QS01`` int8 framing and blake2b CAS keys, so:
an image written by either restores bit-exactly in the other; equal values
give equal chunk digests, leaf names and skeletons; a second save of the
same state by the other package dedups to zero bytes; bf16 leaves
round-trip (the port carries them as 16-bit words, without ml_dtypes).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt as jckpt
from repro.ckpt.layout import leaf_items as jleaf_items
import repro_torch.ckpt as tckpt
from repro_torch.ckpt.layout import host_array, leaf_items as tleaf_items
from repro_torch.ckpt.plane import DataPlaneConfig
from repro_torch.ckpt.reader import load_manifest
from repro_torch.convert import state_from_jax
from repro_torch.obs.trace import tracer

CODECS = ["raw", "zlib", "int8"]
PKGS = {"jax": jckpt, "torch": tckpt}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree():
    rng = np.random.default_rng(5)
    f32 = lambda *s: (rng.standard_normal(s) * 2).astype(np.float32)
    return {
        "state": {
            "params": {"stack": {"wq": f32(2, 16, 24),
                                 "norm": f32(2, 16).astype(ml_dtypes.bfloat16)},
                       "embed": f32(300).astype(ml_dtypes.bfloat16)},
            "opt_state": {"m": f32(7, 40), "count": np.asarray(3, np.int32)},
            "step": np.asarray(3, np.int32)},
        "data": {"seed": 0, "step": 3, "seq_len": 32},
    }


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    return jnp.asarray(t) if isinstance(t, np.ndarray) else t


def _tree(pkg):
    t = _numpy_tree()
    return _jax_tree(t) if pkg == "jax" else state_from_jax(t, "cpu")


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        return host_array(leaf).tobytes(), tuple(leaf.shape)
    if hasattr(leaf, "dtype"):
        a = np.asarray(leaf)
        if a.dtype == ml_dtypes.bfloat16:
            a = a.view(np.int16)
        return a.tobytes(), a.shape
    return leaf


def _flat_bits(tree, pkg):
    items = jleaf_items(tree) if pkg == "jax" else tleaf_items(tree)
    return [(name, _bits(leaf)) for name, leaf in items]


def _restore(pkg, store, prefix, step=None):
    if pkg == "jax":
        return jckpt.restore(store, prefix, step)[0]
    return tckpt.restore(store, prefix, step, device="cpu")[0]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_image_restores_bit_exactly_in_other_package(writer, reader, codec):
    store = tckpt.InMemoryStore()
    PKGS[writer].save_checkpoint(store, "img", 1, _tree(writer), codec=codec)
    theirs = _restore(reader, store, "img")
    ours = _restore(writer, store, "img")
    assert _flat_bits(theirs, reader) == _flat_bits(ours, writer)
    if codec != "int8":                 # lossless: the original values
        assert _flat_bits(theirs, reader) == _flat_bits(_tree(writer), writer)
    assert list(theirs) == ["state", "data"]          # skeleton order kept
    assert theirs["data"] == {"seed": 0, "step": 3, "seq_len": 32}


@pytest.mark.parametrize("codec", CODECS)
def test_equal_values_give_equal_digests_and_manifests(codec):
    mans = {}
    for pkg in PKGS:
        mans[pkg] = PKGS[pkg].save_checkpoint(tckpt.InMemoryStore(), "img", 4,
                                              _tree(pkg), codec=codec)
    j, t = mans["jax"], mans["torch"]
    assert list(j.leaves) == list(t.leaves)            # names and order
    for name in j.leaves:
        lj, lt = j.leaves[name], t.leaves[name]
        assert (lj.shape, lj.dtype, lj.kind) == (lt.shape, lt.dtype, lt.kind)
        assert [c.hash for c in lj.chunks] == [c.hash for c in lt.chunks]
    for m in (j, t):
        m.metadata.pop("time")
    assert j.to_json() == t.to_json()                  # MANIFEST bytes


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_resave_in_other_package_dedups_to_zero(first, second, codec):
    store = tckpt.InMemoryStore()
    PKGS[first].save_checkpoint(store, "img", 1, _tree(first), codec=codec)
    man = PKGS[second].save_checkpoint(store, "img", 2, _tree(second),
                                       codec=codec)
    assert man.metadata["dedup"]["dedup_misses"] == 0
    assert man.metadata["dedup"]["bytes_written"] == 0


@pytest.mark.parametrize("codec", CODECS + ["int8+zlib"])
def test_bf16_leaves_round_trip_in_port(codec):
    x = torch.randn(3, 257, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    store = tckpt.InMemoryStore()
    tckpt.save_checkpoint(store, "p", 1, {"x": x}, codec=codec)
    out = tckpt.restore(store, "p", device="cpu")[0]["x"]
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    if codec in ("raw", "zlib"):
        assert torch.equal(out.view(torch.int16), x.view(torch.int16))
    else:                                # int8: what the reference decodes
        xn = host_array(x).view(ml_dtypes.bfloat16)
        jstore = jckpt.InMemoryStore()
        jckpt.save_checkpoint(jstore, "p", 1, {"x": jnp.asarray(xn)},
                              codec=codec)
        want = np.asarray(jckpt.restore(jstore, "p")[0]["x"])
        assert host_array(out).tobytes() == want.view(np.int16).tobytes()


def test_restore_needs_a_device_or_an_explicit_cpu(monkeypatch):
    store = tckpt.InMemoryStore()
    tckpt.save_checkpoint(store, "p", 1, {"x": torch.ones(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore(store, "p")


@pytest.mark.parametrize("workers,budget", [(1, 0), (4, 1), (4, 256 << 20)])
def test_int8_leaves_decode_through_the_chunk_source(workers, budget):
    """Float leaves of an int8 image are rebuilt by ``qsnap_dequantize``
    where they land, but fetched like every other chunk: through the
    restore's source (prefetch budget, single-flight cache), one
    ``restore/fetch_decode`` span per distinct chunk. Two equal leaves
    share one fetch; the values are what the JAX package restores."""
    t = _numpy_tree()
    t["state"]["params"]["twin"] = t["state"]["opt_state"]["m"].copy()
    store = tckpt.InMemoryStore()
    jckpt.save_checkpoint(store, "img", 1, _jax_tree(t), codec="int8")
    tid = f"int8-source-{workers}-{budget}"
    plane = DataPlaneConfig(fetch_workers=workers, max_inflight_bytes=budget)
    ours = tckpt.restore(store, "img", device="cpu", plane=plane,
                         trace_id=tid)[0]
    assert _flat_bits(ours, "torch") == _flat_bits(
        jckpt.restore(store, "img")[0], "jax")

    man = load_manifest(store, "img", 1)
    by_key = {}
    for name, li in man.leaves.items():
        if li.dtype in ("float32", "bfloat16"):
            by_key.setdefault(li.chunks[0].key, []).append(name)
    assert sorted(map(len, by_key.values())) == [1, 1, 1, 2]   # the twins
    fetched = [s.args["leaf"] for s in
               tracer().spans(name="restore/fetch_decode", trace_id=tid)
               if man.leaves[s.args["leaf"]].dtype in ("float32", "bfloat16")]
    assert len(fetched) == len(by_key)
    assert {k for k, names in by_key.items() if set(names) & set(fetched)} \
        == set(by_key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assemble_region_decodes_an_int8_leaf_on_the_host(dtype):
    """``_assemble_region`` materializes any region of any leaf, as the
    reference's does: a float leaf of an int8 image stored as one chunk
    (which ``restore`` decodes on the device) is dequantized on the host
    here, bit for bit what the reference reader assembles."""
    from repro.ckpt import reader as jreader
    from repro_torch.ckpt import reader as treader
    x = (np.random.default_rng(11).standard_normal((4, 256)) * 3).astype(
        np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    store = tckpt.InMemoryStore()
    jckpt.save_checkpoint(store, "img", 1, {"w": jnp.asarray(x)},
                          codec="int8")
    man = load_manifest(store, "img", 1)
    li = man.leaves["w"]
    for off, shp in (((0, 0), (4, 256)), ((1, 37), (2, 100))):
        srcs = [mod._ChunkSource(store, man.codec, "img", None)
                for mod in (treader, jreader)]
        for src in srcs:
            src.register(li, li.chunks[0])
        ours = treader._assemble_region(srcs[0], li, off, shp)
        want = np.asarray(jreader._assemble_region(srcs[1], li, off, shp))
        assert ours.shape == want.shape == shp
        assert ours.tobytes() == want.tobytes()
