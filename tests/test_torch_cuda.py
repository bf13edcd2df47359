"""The port on the card: the qsnap CUDA kernels against their plain
versions, the int8 restore decoding on the device, and the bit-exact
resume on CUDA, at small sizes.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither JAX nor ``repro``, so it runs
on the machine with the card, without the repo's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.ckpt import InMemoryStore, restore, save_checkpoint
from repro_torch.ckpt import compression
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import qsnap
from repro_torch.train.trainer import TrainerApp, encode_state_on_device
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(reduced(get_config("repro-100m")), dtype="float32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the qsnap CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _ties(scale: float = 1.0) -> torch.Tensor:
    """absmax 127 -> scale exactly 1.0; k + 0.5 are exact .5 ties."""
    half = torch.arange(127, dtype=torch.float32) + 0.5
    return torch.cat([torch.tensor([127.0]), half, -half,
                      torch.zeros(1)]) * scale


def _case(name: str, dtype: torch.dtype) -> torch.Tensor:
    g = torch.Generator().manual_seed(3)
    n = {"one": 1, "block": 256, "ragged": 1000, "odd": 257,
         "large": 76_800}.get(name, 768)
    x = torch.randn(n, generator=g) * 5
    if name == "mixed":                   # ties | all-zero block | random
        x[:256], x[256:512] = _ties(4.0), 0.0
    return x.to(dtype)


NAMES = ["one", "block", "ragged", "odd", "large", "mixed"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_kernels_bitequal_to_plain(dev, name, dtype):
    x = _case(name, dtype)
    before = dict(qsnap.LAUNCHES)
    codes, scales = qsnap.qsnap_quantize(x.to(dev))
    torch.cuda.synchronize()
    assert qsnap.LAUNCHES["quantize"] == before["quantize"] + 1
    pc, ps = qsnap.qsnap_quantize_plain(x)
    assert torch.equal(codes.cpu(), pc) and torch.equal(scales.cpu(), ps)
    hc, hs = compression.quantize_int8(x.float().numpy())
    assert np.array_equal(codes.cpu().numpy(), hc)
    for out in DTYPES:
        got = qsnap.qsnap_dequantize(codes, scales, out).cpu()
        want = qsnap.qsnap_dequantize_plain(pc, ps, out)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert qsnap.LAUNCHES["dequantize"] == before["dequantize"] + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(512, device=dev)
    with pytest.raises(TypeError):
        qsnap.qsnap_quantize_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous 1-D"):
        qsnap.qsnap_quantize_cuda(x.view(2, 256))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        qsnap.qsnap_quantize_cuda(x[::2])
    codes, scales = qsnap.qsnap_quantize_cuda(x)
    with pytest.raises(ValueError, match="do not match"):
        qsnap.qsnap_dequantize_cuda(codes, scales[:1])
    with pytest.raises(TypeError):
        qsnap.qsnap_dequantize_cuda(codes, scales, torch.float16)


def test_encode_chunks_on_card_equal_host_codec(dev):
    leaves = [_case("mixed", torch.bfloat16).view(3, 256),
              _case("ragged", torch.float32),
              torch.tensor(5, dtype=torch.int32)]
    on_card = qsnap.qsnap_encode_chunks([t.to(dev) for t in leaves])
    on_cpu = qsnap.qsnap_encode_chunks(leaves)
    assert on_card == on_cpu


@pytest.mark.parametrize("codec", ["int8", "int8+zlib"])
def test_int8_restore_decodes_on_card_like_the_host(dev, codec):
    tree = {"w": _case("mixed", torch.bfloat16),
            "m": _case("ragged", torch.float32).view(10, 100)}
    store = InMemoryStore()
    save_checkpoint(store, "p", 1, tree, codec=codec)
    before = qsnap.LAUNCHES["dequantize"]
    on_card = restore(store, "p", device=dev)[0]
    assert qsnap.LAUNCHES["dequantize"] == before + 2
    on_cpu = restore(store, "p", device="cpu")[0]
    for k in tree:
        assert on_card[k].device.type == "cuda"
        assert torch.equal(on_card[k].cpu(), on_cpu[k])


def _run(app, restore_state=None):
    app.start(None, restore_state)
    while not app.is_done():
        time.sleep(0.01)
    app.stop()
    return app


def test_lossless_resume_bit_exact_on_card(dev):
    mk = lambda n: TrainerApp(CFG, global_batch=2, seq_len=32, n_steps=n,
                              device=dev)
    straight = _run(mk(6))
    half = _run(mk(3))
    store = InMemoryStore()
    save_checkpoint(store, "t", 3, half.snapshot_async(), codec="raw")
    resumed = _run(mk(6), restore(store, "t", device=dev)[0])
    assert resumed.losses == straight.losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed.checkpoint_state()["state"]),
        tree_leaves(straight.checkpoint_state()["state"])))


def test_card_and_cpu_trainers_agree(dev):
    """The same init and batches on the card and on the CPU (f32, no TF32):
    losses within 1e-4 relative (the two order their sums differently)."""
    cpu = _run(TrainerApp(CFG, global_batch=2, seq_len=32, n_steps=3,
                          device="cpu"))
    card = _run(TrainerApp(CFG, global_batch=2, seq_len=32, n_steps=3,
                           device=dev))
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)
    encoded = encode_state_on_device(card.checkpoint_state()["state"])
    assert len(tree_leaves(encoded)) == len(tree_leaves(
        card.checkpoint_state()["state"]))
