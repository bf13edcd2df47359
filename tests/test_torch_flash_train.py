"""The train step's flash route on the CPU: the plain versions of the
flash forward's ``lse`` and of its backward against the autograd of
``layers.attention_ref`` in f64; the autograd function that carries them
(``ops.flash_attention_train``), also under ``torch.utils.checkpoint``;
``layers._attend``'s route rule and its registry counters; and the
benchmark's reader of those counters (``attn_kernel_share.train``).

The kernels themselves run on the card only: ``tests/test_torch_cuda.py``.
"""
import importlib.util
import math
import types
from pathlib import Path

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.obs.telemetry import MetricsRegistry, use_registry

ROOT = Path(__file__).resolve().parent.parent
KERNEL, PLAIN = L.TRAIN_ROUTES

# (B, S, H, Hkv, hd, causal, window, scale): g = H / Hkv of 1, 2 and 4; S
# no multiple of a kernel tile (32, 64, 128)
CASES = [
    (2, 37, 4, 4, 64, True, None, None),
    (1, 45, 4, 2, 64, False, None, None),
    (2, 29, 8, 2, 128, True, None, None),
    (1, 50, 4, 1, 64, True, 7, None),
    (1, 33, 4, 2, 128, True, None, 0.21),
    (1, 40, 8, 2, 64, False, 9, 0.3),
]


def _qkv(case, seed=0, dtype=torch.float64):
    B, S, H, Hkv, hd = case[:5]
    g = torch.Generator().manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g, dtype=dtype)  # noqa: E731
    return mk(B, S, H, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd), mk(B, S, H,
                                                                    hd)


def _kw(case):
    return dict(causal=case[5], window=case[6], scale=case[7])


def _bhsd(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


def _close(got, want, rtol=2e-5):
    """Within ``rtol`` of ``want``'s largest magnitude (the plain versions
    compute in f32)."""
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_forward_lse_matches_attention_ref(case):
    q, k, v, _ = _qkv(case)
    want, want_lse = L.attention_ref(q, k, v, return_lse=True, **_kw(case))
    out, lse = ref.flash_attention_lse_ref(*_bhsd(q, k, v), **_kw(case))
    assert lse.dtype == torch.float32 and lse.shape == (case[0], case[2],
                                                        case[1])
    _close(out.transpose(1, 2), want)
    _close(lse, want_lse.transpose(1, 2))
    # the plain forward without lse is the same output
    assert torch.equal(ref.flash_attention_ref(*_bhsd(q, k, v), **_kw(case)),
                       out)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd_of_attention_ref(case):
    q, k, v, do = _qkv(case, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = L.attention_ref(*leaves, **_kw(case))
    want = torch.autograd.grad(o, leaves, do)
    o_p, lse = ref.flash_attention_lse_ref(*_bhsd(q, k, v), **_kw(case))
    qt, kt, vt, dot = _bhsd(q, k, v, do)
    got = FA.flash_attention_bwd_bhsd(qt, kt, vt, o_p, dot, lse,
                                      **_kw(case))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g.transpose(1, 2), w)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_train_function_matches_attention_ref(case):
    q, k, v, do = _qkv(case, seed=2)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    oa = L.attention_ref(*a, **_kw(case))
    ob = ops.flash_attention_train(*b, **_kw(case))
    _close(ob, oa)
    for ga, gb in zip(torch.autograd.grad(oa, a, do),
                      torch.autograd.grad(ob, b, do)):
        _close(gb, ga)


def test_train_function_under_checkpoint_recomputes_its_forward():
    """Remat (``torch.utils.checkpoint``, as ``stack_forward`` runs it)
    gives the same bits as no remat, and runs the forward twice: once in
    the forward, once in the backward's recompute."""
    case = CASES[2]
    q, k, v, do = _qkv(case, seed=3, dtype=torch.float32)
    calls = []
    fwd = ops._FlashTrain.forward

    def counted(ctx, *a):
        calls.append(1)
        return fwd(ctx, *a)

    def body(q, k, v):
        return ops.flash_attention_train(q, k, v, **_kw(case)) * 2.0

    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(body(*plain), plain, do)
    remat = [t.clone().requires_grad_() for t in (q, k, v)]
    try:
        ops._FlashTrain.forward = staticmethod(counted)
        out = checkpoint(body, *remat, use_reentrant=False)
        assert len(calls) == 1
        got = torch.autograd.grad(out, remat, do)
        assert len(calls) == 2
    finally:
        ops._FlashTrain.forward = staticmethod(fwd)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_trains_on_the_card_in_bf16_at_head_dims_64_and_128():
    """The rule, on stand-ins for card tensors (this host has none)."""
    def card(dtype, hd):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                     shape=(1, 8, 2, hd))
    assert ops.flash_trains(card(torch.bfloat16, 64))
    assert ops.flash_trains(card(torch.bfloat16, 128))
    for dtype, hd in [(torch.float32, 128), (torch.float16, 64),
                      (torch.bfloat16, 256), (torch.bfloat16, 32),
                      (torch.bfloat16, 96)]:
        assert not ops.flash_trains(card(dtype, hd))
    for dtype in (torch.bfloat16, torch.float32):
        assert not ops.flash_trains(torch.zeros(1, 8, 2, 64, dtype=dtype))


def _route(dtype=torch.float32, hd=64, **kw):
    """One ``_attend`` call with grad enabled: (out, counters)."""
    case = (1, 20, 4, 2, hd, True, None, None)
    q, k, v, _ = _qkv(case, seed=4, dtype=dtype)
    with use_registry(MetricsRegistry()) as reg:
        out = L._attend(None, q.requires_grad_(), k, v, causal=True,
                        window=None, **kw)
        return out, {n: reg.value(n) for n in L.TRAIN_ROUTES}


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 256)], ids=str)
def test_attend_keeps_attention_ref_on_the_cpu(dtype, hd):
    """A CPU tensor (f32 or bf16, any head dim) keeps ``attention_ref``,
    bit for bit, and counts the plain route."""
    case = (1, 20, 4, 2, hd, True, None, None)
    q, k, v, _ = _qkv(case, seed=4, dtype=dtype)
    out, counts = _route(dtype, hd, self_attn=True)
    assert torch.equal(out, L.attention_ref(q, k, v, causal=True))
    assert counts == {KERNEL: 0, PLAIN: 1}


def test_attend_takes_the_kernels_where_they_train(monkeypatch):
    """Where ``flash_trains`` holds, self-attention runs
    ``flash_attention_train`` (its plain versions here) and counts the
    kernel route; cross-attention (no ``self_attn``) keeps
    ``attention_ref``; a call without grad counts nothing."""
    monkeypatch.setattr(ops, "flash_trains", lambda q: True)
    called = []
    real = ops.flash_attention_train

    def spy(*a, **kw):
        called.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention_train", spy)
    out, counts = _route(self_attn=True, scale=0.2)
    assert called == [dict(causal=True, window=None, scale=0.2)]
    assert counts == {KERNEL: 1, PLAIN: 0}
    case = (1, 20, 4, 2, 64, True, None, None)
    q, k, v, _ = _qkv(case, seed=4, dtype=torch.float32)
    _close(out, L.attention_ref(q, k, v, causal=True, scale=0.2))
    _, counts = _route()                                # cross-attention
    assert counts == {KERNEL: 0, PLAIN: 1} and len(called) == 1
    with torch.no_grad():
        _, counts = _route(self_attn=True)
    assert counts == {KERNEL: 0, PLAIN: 0} and len(called) == 2


def test_attend_keeps_the_head_dim_split_plain(monkeypatch):
    """A q split over head_dim runs ``headdim_attention`` whatever the
    tensor, and counts the plain route."""
    monkeypatch.setattr(ops, "flash_trains", lambda q: True)
    seen = []
    monkeypatch.setattr(L, "headdim_attention",
                        lambda q, k, v, **kw: seen.append(kw) or q)
    monkeypatch.setattr(L, "_attend_kv", lambda hs, t: t)
    q, k, v, _ = _qkv(CASES[0], dtype=torch.float32)
    with use_registry(MetricsRegistry()) as reg:
        L._attend(types.SimpleNamespace(q_dim=True), q, k, v, causal=True,
                  window=None, self_attn=True)
        assert len(seen) == 1
        assert {n: reg.value(n) for n in L.TRAIN_ROUTES} == {KERNEL: 0,
                                                             PLAIN: 1}


def test_model_train_step_counts_its_attention_layers():
    """A reduced model's loss and backward under full remat on the CPU
    count one plain route for every attention layer's forward and one
    for its recompute."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    cfg = reduced(get_config("repro-100m"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(leaf.is_floating_point())
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with use_registry(MetricsRegistry()) as reg:
        loss, _ = model.loss(params, {"tokens": tokens, "targets": tokens},
                             remat=True)
        assert reg.value(PLAIN) == cfg.n_layers
        loss.backward()
        assert reg.value(PLAIN) == 2 * cfg.n_layers
        assert reg.get(KERNEL) is None


def _reader():
    path = ROOT / "cacs_bench" / "metrics" / "attn_kernel_share.train.py"
    spec = importlib.util.spec_from_file_location("attn_kernel_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,plain,want", [
    (None, None, None), (12, None, 100.0), (None, 5, 0.0), (3, 1, 75.0),
    (0, 0, None)])
def test_attn_kernel_share_reader(kernel, plain, want):
    """100 x kernel / (kernel + plain) from the counters as they stand;
    nothing from a program without either counter (the parent's)."""
    read = _reader().read
    with use_registry(MetricsRegistry()) as reg:
        for name, n in zip(L.TRAIN_ROUTES, (kernel, plain)):
            if n is not None:
                reg.counter(name).inc(n)
        got = read(None)
    assert got == (None if want is None else pytest.approx(want))
    assert math.isfinite(got) if got is not None else True
