"""The port on the card: the qsnap and attention CUDA kernels against
their plain versions (head dims 32 to 256; the decode kernel's
log-sum-exp too, at an empty slice, a chunk edge and the last slot),
the int8 restore decoding on
the device, the bit-exact resume on CUDA of a trainer and of served
token streams (dense and xLSTM), a reduced enc-dec engine through the
kernels against the oracles, and the MoE and Mamba blocks under the
card's deterministic mode (reduced jamba and llama4-scout against the
CPU plain path, an int8 swap-out of a jamba trainer, bit-equal hybrid
decode steps), the decode kernel with ``pos`` read from the card and
the decode step replayed from a CUDA graph, at small sizes.

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
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import qsnap, ref
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE
from repro_torch.obs.telemetry import registry
from repro_torch.serve.engine import Engine, ServeApp
from repro_torch.train.trainer import TrainerApp, encode_state_on_device
from repro_torch.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(reduced(get_config("repro-100m")), dtype="float32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no "
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


# sizes on the edges of the dequantize kernel's CTA tile
DEQUANT_EDGES = ["block", "tile_minus_block", "tile", "tile_plus_block",
                 "tiles"]


def _dequant_inputs(name: str, tile: int):
    """Codes and scales of ``name``'s size: random codes with runs at
    +127 and -127, an all-zero block (scale 1.0, as quantize gives it) and
    a last block at -127."""
    n = {"block": 256, "tile_minus_block": tile - 256, "tile": tile,
         "tile_plus_block": tile + 256, "tiles": 3 * tile + 512}[name]
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(-127, 128, (n,), generator=g,
                          dtype=torch.int16).to(torch.int8)
    scales = torch.rand(n // 256, generator=g) * 0.1 + 1e-3
    codes[:64], codes[64:128] = 127, -127
    if n >= 768:
        codes[256:512], scales[1] = 0, 1.0
        codes[-256:] = -127
    return codes, scales


@pytest.mark.parametrize("out", DTYPES)
@pytest.mark.parametrize("size", DEQUANT_EDGES)
def test_dequantize_kernel_tiling_edges(dev, size, out):
    codes, scales = _dequant_inputs(size, qsnap.dequantize_tile())
    want = qsnap.qsnap_dequantize_plain(codes, scales, out)
    cd, sd = codes.to(dev), scales.to(dev)
    got = qsnap.qsnap_dequantize_cuda(cd, sd, out)
    again = qsnap.qsnap_dequantize_cuda(cd, sd, out)
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(again.view(torch.uint8), got.view(torch.uint8))


def test_dequantize_refuses_unaligned_codes_and_out(dev):
    codes, scales = qsnap.qsnap_quantize_cuda(torch.randn(1024, device=dev))
    buf = torch.zeros(1024 + 16, dtype=torch.int8, device=dev)
    for off in (1, 8):
        with pytest.raises(ValueError, match="16-byte"):
            qsnap.qsnap_dequantize_cuda(buf[off:off + 1024], scales)
    out = torch.empty(1024 + 4, device=dev)[2:]          # 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        qsnap.check_aligned("x", codes, scales, out)
    qsnap.check_aligned("x", codes, scales, torch.empty(1024, device=dev))


@pytest.mark.parametrize("codec", ["int8", "int8+zlib"])
def test_int8_restore_decodes_on_card_like_the_host(dev, codec):
    # both leaves cross a tile of the dequantize kernel; m's is ragged
    tile = qsnap.dequantize_tile()
    g = torch.Generator().manual_seed(4)
    tree = {"w": torch.cat([_case("mixed", torch.float32),
                            torch.randn(2 * tile, generator=g)]
                           ).to(torch.bfloat16),
            "m": (torch.randn(tile + 1000, generator=g) * 5).view(-1, 8)}
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


# ---------------------------------------------------------------------------
# attention kernels (the grids of tests/test_kernels.py, without the TPU
# block sizes, plus a hd=32 ragged case and a non-causal kv_len case)
# ---------------------------------------------------------------------------

FLASH_CASES = [   # (B, S, H, Hkv, hd, window)
    (2, 128, 4, 2, 64, None), (1, 256, 8, 8, 128, None),
    (2, 192, 4, 2, 64, 64), (1, 128, 6, 2, 96, None),
    (1, 96, 4, 1, 128, 32), (1, 100, 4, 2, 32, None),
    (1, 160, 4, 2, 256, None), (1, 200, 4, 2, 256, 64)]   # gemma3's hd
DECODE_CASES = [  # (B, T, H, Hkv, hd, pos)
    (2, 512, 8, 2, 64, 300), (1, 1024, 4, 4, 128, 1023),
    (3, 256, 8, 4, 96, 0), (1, 640, 16, 2, 128, 400), (2, 100, 4, 1, 32, 77),
    (2, 700, 4, 2, 256, 650)]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(dev, dtype, *shape, seed=5):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return torch.randn(*shape, generator=g).to(dtype).to(dev)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, case, dtype):
    B, S, H, Hkv, hd, window = case
    q = _randn(dev, dtype, B, H, S, hd)
    k, v = _randn(dev, dtype, B, Hkv, S, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, S, hd, seed=7)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention_bhsd(q, k, v, causal=True, window=window)
    assert FA.LAUNCHES["flash_attention"] == before + 1
    _close(got, FA.flash_attention_bhsd_plain(q, k, v, window=window), dtype)
    # two launches give the same bits, and a skipped tile is a masked one
    assert torch.equal(got, FA.flash_attention_bhsd_cuda(q, k, v,
                                                         window=window))
    assert torch.equal(got, FA.flash_attention_bhsd_cuda(
        q, k, v, window=window, skip_masked_tiles=False))


def test_flash_kernel_non_causal_with_kv_len(dev):
    q = _randn(dev, torch.float32, 2, 4, 70, 64)
    k = _randn(dev, torch.float32, 2, 2, 130, 64, seed=6)
    v = _randn(dev, torch.float32, 2, 2, 130, 64, seed=7)
    pk, pv = k.clone(), v.clone()
    pk[:, :, 100:], pv[:, :, 100:] = 1e4, float("nan")   # past kv_len
    got = FA.flash_attention_bhsd_cuda(q, pk, pv, causal=False, kv_len=100)
    _close(got, FA.flash_attention_bhsd_plain(q, k, v, causal=False,
                                              kv_len=100), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, case, dtype):
    B, T, H, Hkv, hd, pos = case
    q = _randn(dev, dtype, B, H, hd)
    k, v = _randn(dev, dtype, B, Hkv, T, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, T, hd, seed=7)
    before = DA.LAUNCHES["decode_attention"]
    got = DA.decode_attention_bhd(q, k, v, pos)
    assert DA.LAUNCHES["decode_attention"] == before + 1
    _close(got, DA.decode_attention_bhd_plain(q, k, v, pos), dtype)
    assert torch.equal(got, DA.decode_attention_bhd_cuda(q, k, v, pos))
    # slots past pos are never read: poison changes no bit
    pk, pv = k.clone(), v.clone()
    pk[:, :, pos + 1:], pv[:, :, pos + 1:] = 1e4, -1e4
    assert torch.equal(got, DA.decode_attention_bhd_cuda(q, pk, pv, pos))



# a rank's shapes on the (16, 16) production mesh (chip_smoke.py phase
# 11): internlm2-1.8b prefill_32k (one q head over kv head 0, S = T =
# 32768) and seamless-m4t-medium decode_32k (one head, 32,768 slots)
PRODUCTION_RANK_CASES = [("flash", (2, 32768, 1, 1, 128)),
                         ("decode", (8, 32768, 1, 1, 64))]


@pytest.mark.parametrize("kind,case", PRODUCTION_RANK_CASES,
                         ids=lambda c: str(c))
def test_kernels_at_a_production_rank_shape(dev, kind, case):
    B, T, H, Hkv, hd = case
    bf16 = torch.bfloat16
    k, v = _randn(dev, bf16, B, Hkv, T, hd, seed=6), \
        _randn(dev, bf16, B, Hkv, T, hd, seed=7)
    if kind == "flash":
        q = _randn(dev, bf16, B, H, T, hd)
        got = FA.flash_attention_bhsd_cuda(q, k, v)
        _close(got, FA.flash_attention_bhsd_plain(q, k, v), bf16)
    else:
        q = _randn(dev, bf16, B, H, hd)
        got = DA.decode_attention_bhd_cuda(q, k, v, T - 1)
        _close(got, DA.decode_attention_bhd_plain(q, k, v, T - 1), bf16)

# the edges of the bf16 tensor-core flash design (128 stacked rows a block,
# 64- or 32-key tiles) and of the decode split (decode_attention.decode_plan)
FLASH_EDGE_CASES = [  # (B, S, T, H, Hkv, hd, causal, window, kv_len)
    (2, 200, 300, 6, 2, 64, False, None, 277),  # S, kv_len off the tiles
    (1, 333, 333, 4, 4, 32, True, None, None),  # g = 1, hd 32
    (2, 200, 200, 12, 4, 64, True, None, None),  # g = 3 (repro-100m)
    (1, 130, 130, 8, 2, 128, True, None, 100),  # g = 4, hd 128, kv_len < S
    (1, 150, 150, 8, 1, 96, True, None, None),  # g = 8, hd 96
    (1, 300, 300, 6, 2, 64, True, 20, None),  # window < a tile, S > window
    (1, 257, 257, 4, 2, 96, True, 48, None),  # window, hd 96
    (2, 100, 300, 4, 2, 256, False, None, 250),  # hd 256, S != T, kv_len
    (1, 150, 150, 8, 1, 256, True, 40, None)]  # hd 256, g = 8, window
DECODE_EDGE_CASES = [  # (B, T, H, Hkv, hd, pos): T far past a chunk
    (1, 4096, 4, 1, 128, 0), (1, 4096, 4, 1, 128, 63),   # pos 0; chunk - 1
    (1, 4096, 4, 1, 128, 64), (1, 4096, 4, 1, 128, 4095),  # chunk; T - 1
    (8, 16384, 8, 8, 64, 16127), (8, 16384, 8, 8, 64, 16128),  # 256 slots
    (8, 16384, 8, 8, 64, 16383), (2, 2048, 16, 1, 64, 1000),  # g = 16
    (2, 1024, 16, 2, 96, 511), (3, 777, 6, 2, 32, 776),
    (1, 4096, 16, 8, 256, 4095), (2, 2048, 8, 1, 256, 1000)]  # hd 256


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
def test_flash_kernel_edges(dev, case, dtype):
    B, S, T, H, Hkv, hd, causal, window, kv_len = case
    q = _randn(dev, dtype, B, H, S, hd)
    k, v = _randn(dev, dtype, B, Hkv, T, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, T, hd, seed=7)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got = FA.flash_attention_bhsd_cuda(q, k, v, **kw)
    _close(got, FA.flash_attention_bhsd_plain(q, k, v, **kw), dtype)
    assert torch.equal(got, FA.flash_attention_bhsd_cuda(q, k, v, **kw))
    assert torch.equal(got, FA.flash_attention_bhsd_cuda(
        q, k, v, skip_masked_tiles=False, **kw))
    if kv_len is not None:          # keys at or past kv_len are never read
        pk, pv = k.clone(), v.clone()
        pk[:, :, kv_len:], pv[:, :, kv_len:] = 1e4, float("nan")
        assert torch.equal(got, FA.flash_attention_bhsd_cuda(q, pk, pv,
                                                             **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_EDGE_CASES)
def test_decode_kernel_edges(dev, case, dtype):
    B, T, H, Hkv, hd, pos = case
    q = _randn(dev, dtype, B, H, hd)
    k, v = _randn(dev, dtype, B, Hkv, T, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, T, hd, seed=7)
    got = DA.decode_attention_bhd_cuda(q, k, v, pos)
    _close(got, DA.decode_attention_bhd_plain(q, k, v, pos), dtype)
    assert torch.equal(got, DA.decode_attention_bhd_cuda(q, k, v, pos))
    k[:, :, pos + 1:], v[:, :, pos + 1:] = 1e4, -1e4
    assert torch.equal(got, DA.decode_attention_bhd_cuda(q, k, v, pos))


# the log-sum-exp a context-parallel rank merges: (T, pos) at an empty
# slice, pos 0, the last slot of the first 64-slot chunk and the first of
# the second (one chunk, then the last-ticket merge), and T - 1
LSE_POS = [(4096, -1), (4096, 0), (4096, 63), (4096, 64), (4096, 4095),
           (300, 299)]
LSE_TOL = 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,pos", LSE_POS, ids=str)
def test_decode_kernel_lse_matches_plain(dev, T, pos, hd, dtype):
    B, H, Hkv = 2, 8, 2
    q = _randn(dev, dtype, B, H, hd)
    k, v = _randn(dev, dtype, B, Hkv, T, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, T, hd, seed=7)
    before = DA.LAUNCHES["decode_attention"]
    out, lse = DA.decode_attention_bhd(q, k, v, pos, return_lse=True)
    assert DA.LAUNCHES["decode_attention"] == before + (pos >= 0)
    want_o, want_l = DA.decode_attention_bhd_plain(q, k, v, pos,
                                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert not torch.isnan(lse).any()
    if pos < 0:
        assert (out == 0).all() and torch.isinf(lse).all() and \
            (lse < 0).all()
        return
    _close(out, want_o, dtype)
    assert float((lse - want_l).abs().max()) <= LSE_TOL
    # asking for lse leaves the output's bits as they were
    assert torch.equal(out, DA.decode_attention_bhd_cuda(q, k, v, pos))


def test_attention_wrappers_refuse_unaligned_views(dev):
    """16-byte copies: a base off 16 bytes or a row stride that is not a
    multiple of 16 bytes is refused, not worked around."""
    bf16 = torch.bfloat16

    def off(*shape):        # base 2 bytes past a 16-byte boundary
        return _randn(dev, bf16, *shape[:-1], shape[-1] + 8)[
            ..., 1:shape[-1] + 1]

    def ragged(*shape):     # rows hd + 4 elements apart
        return _randn(dev, bf16, *shape[:-1], shape[-1] + 4)[
            ..., :shape[-1]]

    q, kv = _randn(dev, bf16, 1, 4, 64, 64), _randn(dev, bf16, 1, 2, 64, 64)
    qd = _randn(dev, bf16, 1, 4, 64)
    for bad in (off, ragged):
        for args in ((bad(1, 4, 64, 64), kv, kv), (q, bad(1, 2, 64, 64), kv),
                     (q, kv, bad(1, 2, 64, 64))):
            with pytest.raises(ValueError, match="16-byte"):
                FA.flash_attention_bhsd_cuda(*args)
        for args in ((bad(1, 4, 64), kv, kv), (qd, bad(1, 2, 64, 64), kv),
                     (qd, kv, bad(1, 2, 64, 64))):
            with pytest.raises(ValueError, match="16-byte"):
                DA.decode_attention_bhd_cuda(*args, 10)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = _randn(dev, torch.float32, 1, 4, 16, 64)
    k = _randn(dev, torch.float32, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="kv_len"):
        FA.flash_attention_bhsd_cuda(q, k, k, kv_len=17)
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention_bhsd_cuda(q, k, k, window=0)
    with pytest.raises(TypeError, match="dtypes"):
        FA.flash_attention_bhsd_cuda(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="pos"):
        DA.decode_attention_bhd_cuda(q[:, :, 0], k, k, 16)


def test_attention_wrappers_take_head_dim_256_and_refuse_160(dev):
    for dt in DTYPES:
        for hd, ok in ((256, True), (160, False)):
            q = _randn(dev, dt, 1, 4, 16, hd)
            k = _randn(dev, dt, 1, 2, 16, hd, seed=6)
            calls = (lambda: FA.flash_attention_bhsd_cuda(q, k, k),
                     lambda: DA.decode_attention_bhd_cuda(q[:, :, 0], k, k,
                                                          15))
            for call in calls:
                if ok:
                    assert call().shape[-1] == hd
                else:
                    with pytest.raises(ValueError, match="head dim 160"):
                        call()


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------

def _serve(dev, cls=ServeApp, restore_state=None):
    app = cls(CFG, batch=2, prompt_len=8, n_tokens=12, cache_len=24,
              device=dev)
    app.start(None, restore_state)
    app._thread.join(timeout=120)
    assert not app._thread.is_alive() and app.healthy()
    return app


class _PausingServe(ServeApp):
    """Stops its decode loop once 4 tokens exist."""

    def _build(self):
        super()._build()
        real = self.engine.decode

        def decode(cache, token, pos):
            if self.generated >= 4:
                self._stop.set()
            return real(cache, token, pos)
        self.engine.decode = decode


def test_served_token_stream_resumes_bit_exact_on_card(dev):
    n_layers = CFG.n_layers
    f0, d0 = FA.LAUNCHES["flash_attention"], DA.LAUNCHES["decode_attention"]
    straight = _serve(dev)
    assert FA.LAUNCHES["flash_attention"] - f0 == n_layers
    assert DA.LAUNCHES["decode_attention"] - d0 == n_layers * 11
    paused = _serve(dev, _PausingServe)
    assert paused.generated == 5
    store = InMemoryStore()
    save_checkpoint(store, "s", 5, paused.snapshot_async(), codec="raw")
    resumed = _serve(dev, restore_state=restore(store, "s", device=dev)[0])
    assert np.array_equal(resumed.checkpoint_state()["tokens_out"],
                          straight.checkpoint_state()["tokens_out"])


def test_serving_kernels_agree_with_the_oracles_on_card(dev):
    model = build_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, CFG.vocab_size, (2, 12), generator=g).to(dev)
    runs = {}
    for impl in (None, "ref"):
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      cache_len=24, impl=impl)
        out = [logits]
        for i in range(6):
            tok = torch.argmax(logits, -1)[:, None]
            logits, cache = model.decode_step(params, cache, tok, 12 + i,
                                              impl=impl)
            out.append(logits)
        runs[impl] = torch.stack(out)
    torch.testing.assert_close(runs[None], runs["ref"], rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[None].argmax(-1), runs["ref"].argmax(-1))


def test_encdec_engine_kernels_agree_with_the_oracles_on_card(dev):
    """Reduced f32 seamless-m4t-medium: the encoder and the cross-attention
    prefill through the flash kernel (non-causal, S != T), the decoder's
    self- and cross-attention decode through the decode kernel, against
    the same model with the oracles (impl="ref"): logits within 1e-4,
    greedy tokens equal; one prefill launches the flash kernel 3 times a
    decoder layer's group (encoder, self, cross), a step the decode kernel
    twice."""
    cfg = dataclasses.replace(reduced(get_config("seamless-m4t-medium")),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=g).to(dev),
             "frames": (torch.randn(2, cfg.frontend_len, cfg.d_model,
                                    generator=g) * 0.02).to(dev)}
    runs = {}
    for impl in (None, "ref"):
        f0, d0 = FA.LAUNCHES["flash_attention"], \
            DA.LAUNCHES["decode_attention"]
        logits, cache = model.prefill(params, batch, cache_len=20,
                                      impl=impl)
        out = [logits]
        for i in range(6):
            tok = torch.argmax(logits, -1)[:, None]
            logits, cache = model.decode_step(params, cache, tok, 12 + i,
                                              impl=impl)
            out.append(logits)
        runs[impl] = torch.stack(out)
        if impl is None:
            assert FA.LAUNCHES["flash_attention"] - f0 == \
                cfg.encoder.n_layers + 2 * cfg.n_layers
            assert DA.LAUNCHES["decode_attention"] - d0 == \
                2 * cfg.n_layers * 6
    torch.testing.assert_close(runs[None], runs["ref"], rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[None].argmax(-1), runs["ref"].argmax(-1))


def test_xlstm_served_token_stream_resumes_bit_exact_on_card(dev):
    """A reduced f32 xlstm ServeApp on the card suspended after 5 tokens:
    its image (mLSTM ``C``, ``n``, conv; sLSTM ``c``, ``n``, ``h``, ``m``)
    restores onto ``cuda`` in f32 and resumes the uninterrupted stream bit
    for bit; no attention kernel is launched."""
    xcfg = dataclasses.replace(reduced(get_config("xlstm-125m")),
                               dtype="float32")

    def serve(cls=ServeApp, restore_state=None):
        app = cls(xcfg, batch=2, prompt_len=8, n_tokens=12, cache_len=24,
                  device=dev)
        app.start(None, restore_state)
        app._thread.join(timeout=120)
        assert not app._thread.is_alive() and app.healthy()
        return app
    f0, d0 = FA.LAUNCHES["flash_attention"], DA.LAUNCHES["decode_attention"]
    straight = serve()
    paused = serve(_PausingServe)
    assert paused.generated == 5
    store = InMemoryStore()
    save_checkpoint(store, "x", 5, paused.snapshot_async(), codec="raw")
    state = restore(store, "x", device=dev)[0]
    for name, c in state["cache"].items():
        for kk, t in c.items():
            assert t.device.type == "cuda"
            assert kk == "conv" or t.dtype == torch.float32, (name, kk)
    resumed = serve(restore_state=state)
    assert np.array_equal(resumed.checkpoint_state()["tokens_out"],
                          straight.checkpoint_state()["tokens_out"])
    assert (FA.LAUNCHES["flash_attention"], DA.LAUNCHES["decode_attention"]) \
        == (f0, d0)


def test_service_int8_suspend_resume_on_card(dev):
    """A reduced trainer on the card under the port's CACSService: the
    suspend with ``swap_codec="int8"`` quantizes every float leaf on the
    card (one launch each), the resume decodes each on the card (one
    launch each) and the restored leaves land on ``cuda``."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                  CoordState)
    svc = CACSService({"snooze": SnoozeBackend(4)},
                      {"default": InMemoryStore()})
    try:
        cid = svc.submit(ASR(
            name="train", n_vms=1, backend="snooze",
            app_factory=lambda: TrainerApp(CFG, global_batch=2, seq_len=16,
                                           n_steps=200, device=dev),
            policy=CheckpointPolicy(period_s=0, codec="raw",
                                    swap_codec="int8")))
        svc.wait_for_state(cid, CoordState.RUNNING, 60)
        coord = svc.db.get(cid)
        while coord.app.current_step < 2:
            time.sleep(0.01)
        n_float = sum(t.is_floating_point() for t in tree_leaves(
            coord.app.checkpoint_state()["state"]))
        q0, d0 = qsnap.LAUNCHES["quantize"], qsnap.LAUNCHES["dequantize"]
        svc.apps.suspend(cid)
        assert qsnap.LAUNCHES["quantize"] - q0 == n_float
        svc.apps.resume(cid)
        assert qsnap.LAUNCHES["dequantize"] - d0 == n_float
        coord = svc.db.get(cid)
        assert coord.state == CoordState.RUNNING and coord.app.restarts == 1
        leaves = tree_leaves(coord.app.checkpoint_state()["state"])
        assert all(t.device.type == "cuda" for t in leaves)
        assert all(bool(torch.isfinite(t.float()).all()) for t in leaves)
        step = coord.app.current_step
        while coord.app.current_step < step + 2:
            time.sleep(0.01)
        assert coord.app.healthy()
    finally:
        svc.shutdown()


def test_scheduler_preempts_int8_trainer_for_server_on_card(dev):
    """Phase 6 (a) of chip_smoke.py at a reduced depth: on a one-host cloud
    a priority-9 ServeApp preempts a priority-1 int8 trainer through the
    GlobalScheduler (one quantize launch per float leaf, no attention
    launch), emits the tokens of a server run alone, and when it is
    deleted the scheduler resumes the trainer by itself (one dequantize
    launch per float leaf, leaves on cuda)."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import (ASR, CACSService, CheckpointPolicy,
                                  CoordState, GlobalScheduler)
    want = _serve(dev).checkpoint_state()["tokens_out"]
    svc = CACSService({"snooze": SnoozeBackend(1)},
                      {"default": InMemoryStore()})
    sched = GlobalScheduler(svc)
    svc.attach_scheduler(sched)
    sched.start()
    n_layers = CFG.n_layers
    try:
        low = sched.submit(ASR(
            name="train-low", n_vms=1, backend="snooze", priority=1,
            app_factory=lambda: TrainerApp(CFG, global_batch=2, seq_len=16,
                                           n_steps=400, device=dev),
            policy=CheckpointPolicy(period_s=0, codec="raw",
                                    swap_codec="int8")))
        coord = svc.wait_for_state(low, CoordState.RUNNING, 60)
        app = coord.app
        while app.current_step < 2:
            time.sleep(0.01)
        n_float = sum(t.is_floating_point() for t in tree_leaves(
            app.checkpoint_state()["state"]))
        counts = (qsnap.LAUNCHES, FA.LAUNCHES, DA.LAUNCHES)
        before = [dict(c) for c in counts]
        hi = sched.submit(ASR(
            name="serve-hi", n_vms=1, backend="snooze", priority=9,
            app_factory=lambda: ServeApp(CFG, batch=2, prompt_len=8,
                                         n_tokens=12, cache_len=24,
                                         device=dev),
            policy=CheckpointPolicy(period_s=0, codec="raw")))
        server = svc.wait_for_state(hi, CoordState.RUNNING, 60)
        assert coord.state == CoordState.SUSPENDED
        deadline = time.monotonic() + 120
        while not server.app.is_done():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert np.array_equal(server.app.checkpoint_state()["tokens_out"],
                              want)
        delta = lambda: {k: c[k] - b[k] for c, b in zip(counts, before)
                         for k in c}
        # the f32 trainer's attention keeps attention_ref: no train route
        assert delta() == {"quantize": n_float, "dequantize": 0,
                           "flash_attention": n_layers,
                           "flash_attention_lse": 0,
                           "flash_attention_bwd": 0,
                           "decode_attention": n_layers * 11}
        svc.delete_coordinator(hi)
        while not (coord.state == CoordState.RUNNING and sched.resumes == 1):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert delta()["dequantize"] == n_float
        assert [t[1] for t in sched.decision_trace()] == [
            "submit", "start", "submit", "preempt", "start", "resume"]
        assert app.restarts == 1
        leaves = tree_leaves(app.checkpoint_state()["state"])
        assert all(t.device.type == "cuda" for t in leaves)
        assert all(bool(torch.isfinite(t.float()).all()) for t in leaves)
        step = app.current_step
        while app.current_step < step + 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert app.healthy()
    finally:
        sched.stop()
        svc.shutdown()


# ---------------------------------------------------------------------------
# MoE and Mamba blocks on the card (deterministic mode)
# ---------------------------------------------------------------------------

def _f32(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


JAMBA = _f32("jamba-v0.1-52b")
SCOUT = _f32("llama4-scout-17b-a16e")


def test_moe_dispatch_and_combine_ops_under_deterministic_mode(dev):
    """The index ops of ``moe_apply`` on the card under
    ``torch.use_deterministic_algorithms``: the cumulative count on the
    int one-hot, the dispatch scatter with unique indices, the gathers and
    their backward; against the CPU, the output and aux within rtol=1e-5,
    atol=1e-4 (f32 outputs reach ~35; cuBLAS and the CPU sum in
    different orders) and each grad of a random cotangent within
    rtol=1e-4, atol=1e-4 times its largest magnitude (the router's grad
    is a small sum of the softmax backward's large terms, so its rounding
    follows their scale, not its own); two runs on the card bit-equal."""
    dev = resolve_device(dev)          # as every entry point selects it
    assert torch.are_deterministic_algorithms_enabled()
    for cfg in (JAMBA, SCOUT):
        spec = TMoE.MoESpec(cfg.d_model, cfg.moe, cfg.mlp_act, cfg.norm_eps,
                            d_ff_shared=cfg.d_ff if cfg.moe.shared_expert
                            else 0)
        b = TL.ParamBuilder(torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
        TMoE.moe_init(b, spec)
        g = torch.Generator().manual_seed(1)
        x = torch.randn(2, 40, cfg.d_model, generator=g)   # drops past C
        dy = torch.randn(2, 40, cfg.d_model, generator=g)
        runs = []
        for device in ("cpu", dev, dev):
            p = {k: t.to(device).requires_grad_() for k, t in
                 b.params.items()}
            xd = x.to(device).requires_grad_()
            y, aux = TMoE.moe_apply(p, spec, xd)
            grads = torch.autograd.grad((y * dy.to(device)).sum() + aux,
                                        [xd, *p.values()])
            runs.append([t.detach().cpu() for t in (y, aux, *grads)])
        for i, (a, c) in enumerate(zip(runs[0], runs[1])):
            tol = dict(rtol=1e-5, atol=1e-4) if i < 2 else \
                dict(rtol=1e-4, atol=1e-4 * float(a.abs().max()))
            torch.testing.assert_close(c, a, **tol)
        assert all(torch.equal(a, c) for a, c in zip(runs[1], runs[2]))


@pytest.mark.parametrize("cfg", [JAMBA, SCOUT], ids=lambda c: c.name)
def test_hybrid_loss_and_grads_on_card_match_cpu(dev, cfg):
    """Reduced f32 jamba and llama4-scout: loss, MoE aux and grads on the
    card within 1e-5 (grads 1e-4) of the CPU plain path, same init and
    batch."""
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = TokenPipeline(cfg, 2, 32).next("cpu")
    out = []
    for device in ("cpu", dev):
        leaves = [t.to(device).requires_grad_() for t in tree_leaves(params)]
        loss, met = model.loss(tree_unflatten(params, leaves),
                               {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        out.append((loss.detach().cpu(), met["moe_aux"].detach().cpu(),
                    [g.cpu() for g in grads]))
    (l0, a0, g0), (l1, a1, g1) = out
    assert float(a1) > 0
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=1e-5)
    for a, c in zip(g0, g1):
        torch.testing.assert_close(c, a, rtol=1e-4, atol=1e-4)


def test_jamba_trainer_int8_swap_out_and_lossless_resume_on_card(dev):
    """A reduced jamba trainer: the int8 swap-out quantizes every float
    leaf on the card (the 3-D expert weights and their moments too), the
    restore decodes each on the card onto ``cuda``; a lossless image
    resumes the uninterrupted run bit for bit."""
    mk = lambda n: TrainerApp(JAMBA, global_batch=2, seq_len=32, n_steps=n,
                              device=dev)
    half = _run(mk(3))
    state = half.checkpoint_state()["state"]
    floats = [t for t in tree_leaves(state) if t.is_floating_point()]
    assert any(t.dim() == 4 for t in floats)     # [groups, E, d, f]
    q0, d0 = qsnap.LAUNCHES["quantize"], qsnap.LAUNCHES["dequantize"]
    store = InMemoryStore()
    save_checkpoint(store, "q", 3, half.snapshot_async(codec="int8"),
                    codec="int8")
    assert qsnap.LAUNCHES["quantize"] - q0 == len(floats)
    back = restore(store, "q", device=dev)[0]
    assert qsnap.LAUNCHES["dequantize"] - d0 == len(floats)
    for a, b in zip(tree_leaves(state), tree_leaves(back["state"])):
        assert b.device.type == "cuda" and b.shape == a.shape \
            and b.dtype == a.dtype
        assert bool(torch.isfinite(b.float()).all())
    straight = _run(mk(6))
    save_checkpoint(store, "t", 3, half.snapshot_async(), codec="raw")
    resumed = _run(mk(6), restore(store, "t", device=dev)[0])
    assert half.losses == straight.losses[:3]
    assert resumed.losses == straight.losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed.checkpoint_state()["state"]),
        tree_leaves(straight.checkpoint_state()["state"])))


def test_two_hybrid_decode_steps_of_one_state_are_bit_equal(dev):
    """Reduced jamba in bf16 on the card: the same cache (KV, f32 ``h``,
    conv) decoded twice gives the same logits and the same new cache."""
    cfg = reduced(get_config("jamba-v0.1-52b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g).to(dev)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=20)
    tok = torch.argmax(logits, -1)[:, None]
    out = []
    for _ in range(2):
        c = {k: {kk: t.clone() for kk, t in v.items()}
             for k, v in cache.items()}
        logits, c = model.decode_step(params, c, tok, 16)
        out.append((logits, c))
    (l0, c0), (l1, c1) = out
    assert torch.equal(l0, l1)
    for name in c0:
        for kk in c0[name]:
            assert c0[name][kk].device.type == "cuda"
            assert torch.equal(c0[name][kk], c1[name][kk]), (name, kk)
    assert c0["l1_mamba"]["h"].dtype == torch.float32
    assert not torch.equal(c0["l1_mamba"]["h"], cache["l1_mamba"]["h"])


# ---------------------------------------------------------------------------
# sharded int8 restore, decoded on the card by two ranks sharing it
# ---------------------------------------------------------------------------

def _sharded_int8_rank(rank, world, root, target):
    import os
    from repro_torch.ckpt import LocalFSStore
    from repro_torch.ckpt.layout import host_array, np_dtype
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding.specs import (MeshSharding, distribute,
                                            local_slice, mesh_placements)
    dev = resolve_device("cuda")
    m_a = make_test_mesh((2, 1), ("data", "model"))
    m_b = make_test_mesh((1, 2), ("data", "model"))
    g = torch.Generator().manual_seed(5)
    w = torch.randn(64, 1000, generator=g) * 3
    w[:, :256] = 0.0                                  # all-zero blocks
    b = (torch.randn(32, 512, generator=g)).to(torch.bfloat16)
    tree = {"w": distribute(w.to(dev), m_a,
                            mesh_placements(("data", None), m_a)),
            "b": distribute(b.to(dev), m_a,
                            mesh_placements(("data", None), m_a))}
    store = LocalFSStore(os.path.join(root, "img"))
    q0 = qsnap.LAUNCHES["quantize"]
    man = save_checkpoint(store, "s", 1, tree, codec="int8")
    assert qsnap.LAUNCHES["quantize"] == q0          # host codec
    host = {}
    for name, li in man.leaves.items():               # the host decoder
        full = np.zeros(li.shape, np_dtype(li.dtype))
        for c in li.chunks:
            raw = compression.decode(store.get(c.key), li.dtype, man.codec)
            sl = tuple(slice(o, o + n) for o, n in zip(c.offset, c.shape))
            full[sl] = np.frombuffer(raw, np_dtype(li.dtype)).reshape(c.shape)
        host[name] = torch.from_numpy(full)
    mesh, spec = {"rows": (m_a, ("data", None)),
                  "columns": (m_b, (None, "model"))}[target]
    d0 = qsnap.LAUNCHES["dequantize"]
    out, _ = restore(store, "s", device=dev, shardings={
        "w": MeshSharding(mesh, spec), "b": MeshSharding(mesh, spec)})
    sharded = qsnap.LAUNCHES["dequantize"] - d0
    for name, t in out.items():
        assert t.to_local().device.type == "cuda"
        assert np.array_equal(host_array(t.to_local()),
                              local_slice(host[name], t).numpy()), name
    d0 = qsnap.LAUNCHES["dequantize"]
    whole, _ = restore(store, "s", device=dev)
    for name, t in whole.items():
        assert np.array_equal(host_array(t), host[name].numpy()), name
    return sharded, qsnap.LAUNCHES["dequantize"] - d0


@pytest.mark.parametrize("target,launches", [("rows", 2), ("columns", 4)])
def test_sharded_int8_restore_decodes_on_the_card(dev, tmp_path, target,
                                                 launches):
    """Two gloo ranks on one card: an int8 image saved sharded by rows
    restores sharded by rows (each region one chunk: 2 leaves x 1) or by
    columns (each region over both chunks: 2 x 2); each rank decodes, on
    the card, every chunk its region overlaps, and a whole restore every
    chunk (4), each bit for bit the host decoder's values."""
    from repro_torch.launch.mesh import spawn
    assert spawn(_sharded_int8_rank, 2, str(tmp_path), target,
                 timeout=300) == [(launches, 4)] * 2


# ---------------------------------------------------------------------------
# the decode step replayed from a CUDA graph (serve.engine.Engine)
# ---------------------------------------------------------------------------

# (B, T, H, Hkv, hd), bf16: jamba's served step (32 rows, 4,352 slots, 32
# q heads over 8 kv heads of 128) and the long decode (32,768 slots)
DEVICE_POS_CASES = [(32, 4352, 32, 8, 128), (8, 32768, 12, 4, 64)]


@pytest.mark.parametrize("case", DEVICE_POS_CASES, ids=str)
def test_decode_kernel_device_pos_bit_equal_to_host_pos(dev, case):
    """``pos`` read from the card gives the host ``pos``'s bits at every
    ``pos`` from 0 to T - 1, one launch each; slots past it are never
    read."""
    B, T, H, Hkv, hd = case
    dt = torch.bfloat16
    q = _randn(dev, dt, B, H, hd)
    k, v = _randn(dev, dt, B, Hkv, T, hd, seed=6), \
        _randn(dev, dt, B, Hkv, T, hd, seed=7)
    p = torch.zeros((), dtype=torch.int32, device=dev)
    differs = torch.zeros(T, dtype=torch.bool, device=dev)
    before = DA.LAUNCHES["decode_attention"]
    for pos in range(T):
        p.fill_(pos)
        differs[pos] = (DA.decode_attention_bhd_cuda(q, k, v, pos)
                        != DA.decode_attention_bhd_cuda(q, k, v, p)).any()
    assert DA.LAUNCHES["decode_attention"] == before + 2 * T
    assert not differs.any(), differs.nonzero()[:8, 0].tolist()
    pos = T // 2 + 1
    p.fill_(pos)
    got = DA.decode_attention_bhd_cuda(q, k, v, p)
    k[:, :, pos + 1:], v[:, :, pos + 1:] = 1e4, -1e4
    assert torch.equal(got, DA.decode_attention_bhd_cuda(q, k, v, p))
    with pytest.raises(ValueError, match="0-d int32"):
        DA.decode_attention_bhd_cuda(q, k, v, p.long())


GRAPH_COUNTS = ("serve.decode_graph_captures", "serve.decode_graph_replays",
                "serve.decode_graph_fallbacks")


def _graph_counts():
    return [registry().value(n) for n in GRAPH_COUNTS]


def _launches():
    """Decode and flash kernel launches, windowed ``attention_ref``
    decodes."""
    return (DA.LAUNCHES["decode_attention"], FA.LAUNCHES["flash_attention"],
            registry().value(TL.WINDOW_REF_DECODES))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "internlm2-1.8b",
                                  "gemma3-12b"])
def test_graphed_serving_equals_eager_decode_steps(dev, arch):
    """Reduced f32 jamba, internlm2 and gemma3 (windowed layers, whose
    decode is ``attention_ref``): a ``ServeApp`` whose 64 decode
    steps replay one captured graph serves the tokens of 64 eager
    ``model.decode_step`` calls at host ints, with the eager steps' launch
    counts; ``Engine.decode``'s replayed logits lie within the decode
    tolerance of the eager ones (rtol, atol 1e-4)."""
    cfg, n = _f32(arch), 64
    c0, l0 = _graph_counts(), _launches()
    app = ServeApp(cfg, batch=2, prompt_len=8, n_tokens=n + 1,
                   cache_len=n + 8, device=dev)
    app.start(None, None)
    app._thread.join(timeout=300)
    assert not app._thread.is_alive() and app.healthy()
    graphed = [a - b for a, b in zip(_launches(), l0)]
    assert [a - b for a, b in zip(_graph_counts(), c0)] == [1, n, 0], \
        getattr(registry().get(GRAPH_COUNTS[2]), "note", None)
    served = np.concatenate(app.tokens_out, axis=1)

    model, params = app.model, app.params
    rng = np.random.Generator(np.random.PCG64(app.seed))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                              .astype(np.int32)).to(dev)
    l0 = _launches()
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  cache_len=n + 8)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    tokens, eager = [tok], []
    for i in range(n):
        logits, cache = model.decode_step(params, cache, tok, 8 + i)
        eager.append(logits.clone())
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        tokens.append(tok)
    assert graphed == [a - b for a, b in zip(_launches(), l0)]
    for i, window in ((0, False), (2, True)):
        assert graphed[i] == n * model.n_groups * sum(
            b.kind == "attn" and (b.spec.window is not None) == window
            for b in model.blocks)
    assert np.array_equal(served, torch.cat(tokens, 1).cpu().numpy())

    eng = Engine(model, params, cache_len=n + 8)
    logits, cache = eng.prefill({"tokens": prompt})
    for i in range(n):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        logits, cache = eng.decode(cache, tok, 8 + i)
        torch.testing.assert_close(logits, eager[i], rtol=1e-4, atol=1e-4)


def test_graphed_serve_suspended_and_resumed_keeps_its_tokens(dev):
    """Reduced jamba as served (bf16, f32 Mamba state): a graphed
    ``ServeApp`` suspended after 5 tokens and resumed from its image
    serves the uninterrupted stream; the resumed job's cache tensors are
    new, so it captures again: 2 captures for the two."""
    cfg = reduced(get_config("jamba-v0.1-52b"))

    def serve(cls=ServeApp, restore_state=None):
        app = cls(cfg, batch=2, prompt_len=8, n_tokens=16, cache_len=24,
                  device=dev)
        app.start(None, restore_state)
        app._thread.join(timeout=300)
        assert not app._thread.is_alive() and app.healthy()
        return app
    straight = serve()
    c0 = _graph_counts()
    paused = serve(_PausingServe)
    assert paused.generated == 5
    store = InMemoryStore()
    save_checkpoint(store, "j", 5, paused.snapshot_async(), codec="raw")
    resumed = serve(restore_state=restore(store, "j", device=dev)[0])
    assert np.array_equal(resumed.checkpoint_state()["tokens_out"],
                          straight.checkpoint_state()["tokens_out"])
    captures, replays, fallbacks = [a - b for a, b in
                                    zip(_graph_counts(), c0)]
    assert (captures, replays, fallbacks) == (2, 4 + 11, 0)


def test_graphed_encdec_generate_follows_each_source_length(dev):
    """Reduced f32 seamless-m4t-medium: one ``Engine`` generates for
    sources of two lengths in turn. The cross-attention memory's slots
    follow the source, so each cache is captured for what it holds, even
    where a new one lands at a freed one's addresses: every stream equals
    eager ``model.decode_step`` calls at host ints."""
    cfg = _f32("seamless-m4t-medium")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dev)
    eng, n = Engine(model, params, cache_len=24), 8
    c0 = _graph_counts()
    for F in (cfg.frontend_len, cfg.frontend_len // 2, cfg.frontend_len):
        g = torch.Generator().manual_seed(F)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                         generator=g).to(dev),
                 "frames": (torch.randn(2, F, cfg.d_model, generator=g)
                            * 0.02).to(dev)}
        got = eng.generate(batch, n)
        logits, cache = model.prefill(params, batch, cache_len=24)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        want = [tok]
        for i in range(1, n):
            logits, cache = model.decode_step(params, cache, tok, 12 + i - 1)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            want.append(tok)
        assert torch.equal(got, torch.cat(want, 1)), F
    captures, replays, fallbacks = [a - b for a, b in
                                    zip(_graph_counts(), c0)]
    assert captures >= 2 and replays == 3 * (n - 1) and fallbacks == 0


def test_graphed_serve_replays_while_another_captures(dev):
    """Two graphed ``ServeApp``s of reduced jamba (bf16) on one card, the
    second started while the first replays, at slots past one 64-slot
    chunk (the decode kernel's tickets and multi-chunk combine): each
    serves the stream it serves alone."""
    cfg = reduced(get_config("jamba-v0.1-52b"))

    def app(seed, n_tokens, delay=0.0):
        return ServeApp(cfg, batch=2, prompt_len=64, n_tokens=n_tokens,
                        cache_len=64 + n_tokens, seed=seed, device=dev,
                        token_delay_s=delay)

    def tokens(a):
        a._thread.join(timeout=300)
        assert not a._thread.is_alive() and a.healthy()
        return np.concatenate(a.tokens_out, axis=1)

    alone = []
    for seed, n in ((0, 300), (1, 40)):
        a = app(seed, n)
        a.start(None, None)
        alone.append(tokens(a))
    first, second = app(0, 300, delay=0.005), app(1, 40)
    first.start(None, None)
    while first.generated < 10:
        assert first._thread.is_alive()
        time.sleep(0.001)
    c0 = registry().value(GRAPH_COUNTS[0])
    second.start(None, None)
    while registry().value(GRAPH_COUNTS[0]) == c0:
        assert second._thread.is_alive() and second.healthy()
        time.sleep(0.001)
    assert first.generated < first.n_tokens      # it replayed meanwhile
    assert np.array_equal(tokens(second), alone[1])
    assert np.array_equal(tokens(first), alone[0])


# ---------------------------------------------------------------------------
# granite-4.0-h: attention at a set score scale, Mamba-2 and the dropless
# MoE in a graphed decode step
# ---------------------------------------------------------------------------

GRANITE_ATTN = [(2, 320, 32, 8, 128)]    # jamba's and granite's heads


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", GRANITE_ATTN)
def test_attention_kernels_at_a_set_scale(dev, case, dtype):
    """Both kernels at granite's score scale 1/128 within their tolerance
    of the plain versions at that scale, and far from the default's
    result; at the default (no scale given) each launch equals the
    plain version's within the same tolerance and gives the same bits
    as a launch that names no scale through ``ops``."""
    from repro_torch.kernels import ops
    B, S, H, Hkv, hd = case
    q = _randn(dev, dtype, B, H, S, hd)
    k, v = _randn(dev, dtype, B, Hkv, S, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, S, hd, seed=7)
    s = 1.0 / 128
    got = FA.flash_attention_bhsd(q, k, v, scale=s)
    _close(got, FA.flash_attention_bhsd_plain(q, k, v, scale=s), dtype)
    default = FA.flash_attention_bhsd(q, k, v)
    _close(default, FA.flash_attention_bhsd_plain(q, k, v), dtype)
    assert (got.float() - default.float()).abs().max() > 10 * ATTN_TOL[dtype]
    assert torch.equal(default, ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ).transpose(1, 2))
    for pos in (0, 200, S - 1):
        qd = q[:, :, pos]
        got = DA.decode_attention_bhd(qd, k, v, pos, scale=s)
        _close(got, DA.decode_attention_bhd_plain(qd, k, v, pos, scale=s),
               dtype)
        _close(DA.decode_attention_bhd(qd, k, v, pos),
               DA.decode_attention_bhd_plain(qd, k, v, pos), dtype)
        out, lse = DA.decode_attention_bhd(qd, k, v, pos, return_lse=True,
                                           scale=s)
        want, want_lse = DA.decode_attention_bhd_plain(
            qd, k, v, pos, return_lse=True, scale=s)
        _close(out, want, dtype)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    pos_dev = torch.tensor(200, dtype=torch.int32, device=dev)
    assert torch.equal(DA.decode_attention_bhd(q[:, :, 200], k, v, pos_dev,
                                               scale=s),
                       DA.decode_attention_bhd(q[:, :, 200], k, v, 200,
                                               scale=s))


GRANITE = reduced(get_config("granite-4.0-h-small"))     # bf16, as served


def test_granite_decode_step_has_no_host_sync(dev):
    """An eager decode step of reduced granite (Mamba-2, the dropless
    grouped-GEMM MoE, NoPE attention at pos on the card) reads nothing
    back to the host: ``set_sync_debug_mode("error")`` raises on a sync."""
    model = build_model(GRANITE)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, GRANITE.vocab_size, (4, 8), device=dev)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=16)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    pos = torch.tensor(8, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, cache, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_granite_decode_replays_one_graph(dev):
    """A reduced granite ``ServeApp`` (bf16) on the card: its decode steps
    replay one captured graph with no fallback, serve the tokens of the
    eager steps at host ints, and each replay adds one step's routed
    pairs and expert rows to the registry, equal (dropless: a row a
    pair)."""
    n, B = 32, 4
    c0, l0 = _graph_counts(), _launches()
    m0 = [registry().value(x) for x in ("moe.routed_pairs",
                                        "moe.expert_rows")]
    app = ServeApp(GRANITE, batch=B, prompt_len=8, n_tokens=n + 1,
                   cache_len=n + 8, device=dev)
    app.start(None, None)
    app._thread.join(timeout=300)
    assert not app._thread.is_alive() and app.healthy()
    assert [a - b for a, b in zip(_graph_counts(), c0)] == [1, n, 0], \
        getattr(registry().get(GRAPH_COUNTS[2]), "note", None)
    model = app.model
    n_moe = model.n_groups * sum(b.kind == "moe" for b in model.blocks)
    pairs, rows = [registry().value(x) - m for x, m in zip(
        ("moe.routed_pairs", "moe.expert_rows"), m0)]
    K = GRANITE.moe.top_k
    assert pairs == rows == n_moe * K * B * (8 + n)
    n_attn = model.n_groups * sum(b.kind == "attn" for b in model.blocks)
    assert _launches()[0] - l0[0] == n * n_attn
    served = np.concatenate(app.tokens_out, axis=1)
    rng = np.random.Generator(np.random.PCG64(app.seed))
    prompt = torch.from_numpy(rng.integers(0, GRANITE.vocab_size, (B, 8))
                              .astype(np.int32)).to(dev)
    logits, cache = model.prefill(app.params, {"tokens": prompt},
                                  cache_len=n + 8)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    tokens = [tok]
    for i in range(n):
        logits, cache = model.decode_step(app.params, cache, tok, 8 + i)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        tokens.append(tok)
    assert np.array_equal(served, torch.cat(tokens, 1).cpu().numpy())


# ---------------------------------------------------------------------------
# the train step's flash route: the forward's lse and the backward kernel
# ---------------------------------------------------------------------------

# (B, S, H, Hkv, hd, causal, window): internlm2's head layout (16 q heads
# over 8 of 128) and repro-100m's (12 over 4 of 64), S no multiple of a
# tile; a window and a non-causal case
FLASH_TRAIN = [(2, 520, 16, 8, 128, True, None), (2, 300, 12, 4, 64, True,
                                                   None),
               (1, 384, 8, 2, 128, True, 100), (2, 200, 4, 1, 64, False,
                                                 None)]


def _train_operands(dev, case):
    B, S, H, Hkv, hd = case[:5]
    q, do = (_randn(dev, torch.bfloat16, B, S, H, hd, seed=s) for s in (1, 2))
    k, v = (_randn(dev, torch.bfloat16, B, S, Hkv, hd, seed=s)
            for s in (3, 4))
    return q, k, v, do


@pytest.mark.parametrize("case", FLASH_TRAIN, ids=str)
def test_flash_backward_no_farther_from_f32_than_bf16_autograd(dev, case):
    """dq, dk and dv of the kernels (``ops.flash_attention_train``) are no
    farther (relative L2) from f32 autograd of ``attention_ref`` than bf16
    ``attention_ref``'s own autograd is, on the same bf16 inputs; one
    forward and one backward launch."""
    from repro_torch.kernels import ops
    kw = dict(causal=case[5], window=case[6])
    q, k, v, do = _train_operands(dev, case)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(TL.attention_ref(*f32, **kw), f32, do.float())
    bf = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(TL.attention_ref(*bf, **kw), bf, do)
    kern = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = dict(FA.LAUNCHES)
    got = torch.autograd.grad(ops.flash_attention_train(*kern, **kw), kern,
                              do)
    assert FA.LAUNCHES["flash_attention_lse"] == \
        n0["flash_attention_lse"] + 1
    assert FA.LAUNCHES["flash_attention_bwd"] == \
        n0["flash_attention_bwd"] + 1
    assert FA.LAUNCHES["flash_attention"] == n0["flash_attention"]

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        assert rel(g, w) <= rel(p, w), (rel(g, w), rel(p, w))


@pytest.mark.parametrize("case", FLASH_TRAIN[:2], ids=str)
def test_flash_backward_two_launches_give_the_same_bits(dev, case):
    kw = dict(causal=case[5], window=case[6])
    q, k, v, do = (t.transpose(1, 2) for t in _train_operands(dev, case))
    o, lse = FA.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    first = FA.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    again = FA.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    # and the plain version on the same o and lse agrees within bf16's
    # tolerance
    for a, b in zip(first, ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                       **kw)):
        _close(a, b, torch.bfloat16)


@pytest.mark.parametrize("case", FLASH_TRAIN + [(1, 160, 4, 2, 256, True,
                                                 None)], ids=str)
def test_flash_forward_lse_leaves_the_output_as_it_was(dev, case):
    """With ``lse`` the bf16 forward writes the same output bits as
    without (serving's prefill launches it without), one launch each
    (counted apart: serving's count is ``flash_attention``'s alone), and
    the lse matches the plain version's."""
    B, S, H, Hkv, hd, causal, window = case
    dtype = torch.bfloat16
    q = _randn(dev, dtype, B, H, S, hd)
    k, v = _randn(dev, dtype, B, Hkv, S, hd, seed=6), \
        _randn(dev, dtype, B, Hkv, S, hd, seed=7)
    kw = dict(causal=causal, window=window)
    n0 = dict(FA.LAUNCHES)
    bare = FA.flash_attention_bhsd(q, k, v, **kw)
    out, lse = FA.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    assert FA.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert FA.LAUNCHES["flash_attention_lse"] == \
        n0["flash_attention_lse"] + 1
    assert torch.equal(out, bare)
    want_out, want_lse = FA.flash_attention_bhsd_plain(q, k, v,
                                                       return_lse=True, **kw)
    _close(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_flash_backward_refuses_what_it_does_not_take(dev):
    q, k, v, do = (t.transpose(1, 2)
                   for t in _train_operands(dev, FLASH_TRAIN[1]))
    o, lse = FA.flash_attention_bhsd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="return_lse takes bf16"):
        FA.flash_attention_bhsd(q.float(), k.float(), v.float(),
                                return_lse=True)
    with pytest.raises(ValueError, match="bf16 at"):
        FA.flash_attention_bwd_bhsd(q.float(), k.float(), v.float(),
                                    o.float(), do.float(), lse)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_bhsd(q, k, v, o, do, lse[:, :1])


def _internlm2_cut(dtype):
    """internlm2-1.8b at every published width (16 q heads over 8 of 128,
    the whole vocabulary), 2 of its 24 layers."""
    return dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2,
                               dtype=dtype)


def _leaf_grads(model, params, batch):
    """Every param's gradient of one batch's loss (remat on), in f32."""
    from repro_torch.tree import tree_leaves, tree_map
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(params, batch, remat=True)
    return [g.float() for g in torch.autograd.grad(loss,
                                                   tree_leaves(params))]


def test_reduced_internlm2_train_steps_through_the_kernels(dev):
    """internlm2 cut to 2 layers, in bf16 through the kernels, every
    layer's attention counted on the kernel route, against the same model
    in f32 (``attention_ref``, TF32 off) from the same weights and batches.

    The first batch's gradients, which the backward kernel makes: each
    leaf's relative L2 distance from f32 is no more than that of bf16
    ``attention_ref``'s own autograd (the route the kernels replace) with
    a tenth of room, and the cell's ``grad1_gap`` (each leaf's norm
    against f32's, over the larger of that norm and the median leaf's) is
    within its limit, 3.5e-3. The distances are what hold the backward: a
    norm does not see dk's sign, and the losses below move little with
    the first steps' gradients. Then three train steps
    (``internlm2.swap``'s optimizer, batch 4 x 1024) whose losses are
    within that cell's ``loss_gap`` limit, 1.2e-4, of f32's."""
    import statistics
    from repro_torch.obs.telemetry import MetricsRegistry, use_registry
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_map
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg16 = _internlm2_cut("bfloat16")
    m16 = build_model(cfg16)
    m32 = build_model(_internlm2_cut("float32"))
    p16 = m16.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, p16)
    g = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, cfg16.vocab_size, (4, 1025), generator=g)
               for _ in range(3)]
    opt = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=1_000_000)
    first = {"tokens": batches[0][:, :-1].to(dev),
             "targets": batches[0][:, 1:].to(dev)}

    def losses(model, params):
        step = make_train_step(model, opt, remat=True)
        state = {"params": params, "opt_state": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        out = []
        for t in batches:
            t = t.to(dev)
            state, m = step(state, {"tokens": t[:, :-1],
                                    "targets": t[:, 1:]})
            out.append(float(m["loss"]))
        return out

    with use_registry(MetricsRegistry()) as reg:
        n0 = dict(FA.LAUNCHES)
        got_g = _leaf_grads(m16, p16, first)
        assert FA.LAUNCHES["flash_attention_bwd"] - \
            n0["flash_attention_bwd"] == cfg16.n_layers
        n0 = dict(FA.LAUNCHES)
        got = losses(m16, p16)
        assert reg.value("attn.train_kernel") == 4 * 2 * cfg16.n_layers
        assert reg.get("attn.train_ref") is None
        assert FA.LAUNCHES["flash_attention_bwd"] - \
            n0["flash_attention_bwd"] == 3 * cfg16.n_layers
        assert FA.LAUNCHES["flash_attention_lse"] - \
            n0["flash_attention_lse"] == 3 * 2 * cfg16.n_layers
        want = losses(m32, p32)
        assert reg.value("attn.train_ref") == 3 * 2 * cfg16.n_layers
    want_g = _leaf_grads(m32, p32, first)
    real = ops.flash_trains
    ops.flash_trains = lambda q: False
    try:
        plain_g = _leaf_grads(m16, p16, first)
    finally:
        ops.flash_trains = real

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))
    rel_k = [rel(a, w) for a, w in zip(got_g, want_g)]
    rel_p = [rel(a, w) for a, w in zip(plain_g, want_g)]
    assert all(a <= 1.1 * b for a, b in zip(rel_k, rel_p)), (rel_k, rel_p)
    norms = [float(w.norm()) for w in want_g]
    med = statistics.median(norms)
    grad1_gap = max(abs(float(a.norm()) - n) / max(n, med, 1e-30)
                    for a, n in zip(got_g, norms))
    assert grad1_gap <= 3.5e-3, grad1_gap
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    assert max(gaps) <= 1.2e-4, (got, want, gaps)
