"""The port on the card: the qsnap and attention CUDA kernels against
their plain versions (head dims 32 to 256), the int8 restore decoding on
the device, the bit-exact resume on CUDA of a trainer and of served
token streams (dense and xLSTM), a reduced enc-dec engine through the
kernels against the oracles, and the MoE and Mamba blocks under the
card's deterministic mode (reduced jamba and llama4-scout against the
CPU plain path, an int8 swap-out of a jamba trainer, bit-equal hybrid
decode steps), at small sizes.

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
from repro_torch.kernels import qsnap
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE
from repro_torch.serve.engine import ServeApp
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
        assert delta() == {"quantize": n_float, "dequantize": 0,
                           "flash_attention": n_layers,
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
