"""The port's TrainerApp on the CPU: the four service-free contracts of
``tests/test_train_ckpt.py``, held inside the port, plus parity with the
JAX trainer and the no-torn-snapshot rule.

  * the staged snapshot path restores bit-exactly (lossless guard);
  * device- and host-encoded int8 images of one state are byte-identical
    chunk for chunk (the second save dedups to zero uploads);
  * a host-encoded int8 payload decodes through the dequantize path;
  * pre-encoded (lossy) leaves are rejected by a lossless codec;
  * from the same init and data, N-step losses match the JAX trainer's;
  * a snapshot pinned before a further step resolves to the pinned state.
"""
import dataclasses
import struct
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.train import trainer as jtrainer
from repro_torch.ckpt import (AsyncCheckpointer, InMemoryStore, restore,
                              save_checkpoint)
from repro_torch.ckpt.compression import decode as host_decode
from repro_torch.ckpt.compression import encode as host_encode
from repro_torch.ckpt.layout import host_array
from repro_torch.ckpt.snapshot import SnapshotHandle
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.kernels.qsnap import qsnap_dequantize
from repro_torch.models.model import build_model
from repro_torch.sim.simtime import SimClock, install_clock
from repro_torch.train.trainer import (TrainerApp, encode_state_on_device,
                                       init_state)
from repro_torch.tree import tree_leaves

CFG = dataclasses.replace(treduced(tget_config("repro-100m")), dtype="float32")
JCFG = dataclasses.replace(reduced(get_config("repro-100m")), dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers beside timing-sensitive virtual-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _virtual_time():
    """TrainerApp stamps its steps and stalls on the port's active clock:
    run on a discrete-event SimClock, as the reference's suites do."""
    clk = SimClock()
    prev = install_clock(clk)
    try:
        yield clk
    finally:
        clk.close()
        install_clock(prev)


def _app(**kw):
    kw = {"global_batch": 2, "seq_len": 32, **kw}
    return TrainerApp(CFG, device="cpu", **kw)


def _wait(app):
    while not app.is_done():
        time.sleep(0.01)
    app.stop()
    return app


def _run_to_done(app, restore_state=None):
    app.start(None, restore_state)
    return _wait(app)


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(la, lb))


def test_async_snapshot_restore_bit_exact():
    """Lossless guard: the async path restores the exact run — params,
    opt_state and token stream identical to never-suspended."""
    straight = _run_to_done(_app(n_steps=6))
    half = _run_to_done(_app(n_steps=3))
    handle = half.snapshot_async()             # staged: refs only
    assert isinstance(handle, SnapshotHandle)
    assert handle.step == 3
    assert len(half.ckpt_stalls) == 1
    store = InMemoryStore()
    ck = AsyncCheckpointer(store, "t", codec="raw")
    ck.save(3, handle)                         # resolved on writer thread
    ck.wait()
    ck.close()
    snap, _ = restore(store, "t", device="cpu")

    resumed = _run_to_done(_app(n_steps=6), snap)
    assert resumed.restarts == 1
    assert resumed.losses == straight.losses[3:], "stream diverged"
    assert _tree_equal(resumed.checkpoint_state()["state"],
                       straight.checkpoint_state()["state"])


@pytest.mark.parametrize("codec", ["int8", "int8+zlib"])
def test_device_and_host_int8_images_interchange(codec):
    """Device-encoded and host-encoded int8 images of the same state are
    byte-identical chunk-for-chunk: the second save dedups completely and
    both restore to the same values."""
    app = _run_to_done(_app(n_steps=2))
    state = app.checkpoint_state()
    store = InMemoryStore()
    man_host = save_checkpoint(store, "x", 1, state, codec=codec)
    man_dev = save_checkpoint(store, "x", 2, app.snapshot_async(codec=codec),
                              codec=codec)
    assert man_dev.metadata["dedup"]["dedup_misses"] == 0
    assert man_dev.metadata["dedup"]["bytes_written"] == 0
    host_hashes = {c.hash for li in man_host.leaves.values()
                   for c in li.chunks}
    dev_hashes = {c.hash for li in man_dev.leaves.values()
                  for c in li.chunks}
    assert host_hashes == dev_hashes
    t1, _ = restore(store, "x", 1, device="cpu")
    t2, _ = restore(store, "x", 2, device="cpu")
    assert _tree_equal(t1, t2)
    assert int(t2["data"]["step"]) == 2


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_host_encoded_payload_decodes_through_dequantize(out_dtype):
    """The reverse direction: a host-codec int8 payload dequantizes via
    qsnap_dequantize to the same values as the host decoder."""
    x = (np.random.default_rng(7).standard_normal(4096) * 3).astype(
        np.float32)
    payload = host_encode(x.tobytes(), np.float32, "int8")
    assert payload[:8] == b"QS01INT8"
    n, n_scales = struct.unpack("<qq", payload[8:24])
    scales = np.frombuffer(payload[24:24 + 4 * n_scales], np.float32).copy()
    codes = np.frombuffer(payload[24 + 4 * n_scales:], np.int8).copy()
    dev = qsnap_dequantize(torch.from_numpy(codes), torch.from_numpy(scales),
                           getattr(torch, out_dtype))
    host = host_decode(payload, out_dtype, "int8")
    assert host_array(dev[:n]).tobytes() == host


def test_pre_encoded_leaves_reject_lossless_codec():
    """A lossy device-encoded payload must never satisfy a lossless image
    codec silently."""
    app = _run_to_done(_app(seq_len=16, n_steps=1))
    encoded = encode_state_on_device(app.checkpoint_state()["state"])
    with pytest.raises(ValueError, match="cannot satisfy"):
        save_checkpoint(InMemoryStore(), "x", 1, {"state": encoded},
                        codec="raw")


def test_n_step_losses_match_jax_trainer():
    """Same init (the JAX one, converted) and same batches: the port's
    TrainerApp follows the JAX TrainerApp's losses within 1e-4 relative
    (f32 on the CPU; XLA and torch order their sums differently)."""
    n = 4
    japp = jtrainer.TrainerApp(JCFG, global_batch=2, seq_len=32, n_steps=n)
    japp.start(None, None)
    _wait(japp)
    jstate = jtrainer.init_state(japp.model, jax.random.PRNGKey(0))
    tapp = _app(n_steps=n)
    _run_to_done(tapp, {"state": state_from_jax(jax.device_get(jstate), "cpu"),
                        "data": tapp.pipeline.state_dict()})
    assert len(tapp.losses) == len(japp.losses) == n
    np.testing.assert_allclose(tapp.losses, japp.losses, rtol=1e-4)


def test_pinned_snapshot_survives_further_steps():
    """No in-place update: a snapshot pinned at step 2 resolves to the
    step-2 state even after the trainer has stepped on."""
    app = _run_to_done(_app(n_steps=2))
    pinned = [t.clone() for t in tree_leaves(app.checkpoint_state()["state"])]
    handle = app.snapshot_async()
    app.n_steps = 4
    _run_to_done(app)
    assert app.current_step == 4
    got = tree_leaves(handle.resolve()["state"])
    assert all(torch.equal(a, b) for a, b in zip(pinned, got))
    assert not _tree_equal(app.checkpoint_state()["state"],
                           handle.resolve()["state"])
    assert handle.resolve()["data"]["step"] == 2


def test_trainer_needs_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainerApp(CFG)


@pytest.mark.parametrize("entry", ["init_state", "Model.init",
                                   "params_from_jax", "state_from_jax"])
def test_state_builders_need_a_device_or_an_explicit_cpu(monkeypatch, entry):
    """The functions that build a train state land on the card unless the
    CPU is asked for; with no GPU they raise rather than build on the
    CPU."""
    model = build_model(CFG)
    tree = {"w": np.ones(3, np.float32), "step": 1}
    calls = {
        "init_state": lambda: init_state(model, 0),
        "Model.init": lambda: model.init(torch.Generator().manual_seed(0)),
        "params_from_jax": lambda: params_from_jax({"w": tree["w"]}),
        "state_from_jax": lambda: state_from_jax(tree),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
