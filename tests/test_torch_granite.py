"""granite-4.0-h on the port, on the CPU: Mamba-2 mixers, NoPE attention at a
set score scale, a dropless MoE, and granite's multipliers.

A reduced granite (two periods of one attention and three Mamba-2 layers,
attention at offset 1; 8 experts, top 2; a scan chunk of 16 so that the
longer prompts pass the state between chunks) in float32, with seeded
random weights, against the plain reference ``tests/granite_ref.py``:
the full forward, and the prefill then decode through the cache. The
reference itself is held to transformers' ``GraniteMoeHybridForCausalLM``
(its CPU slow path) on the same weights. Also: the chunked SSD scan
against the step-by-step recurrence; the dropless dispatch against a
per-token loop under a router skewed so that any capacity would drop
pairs; jamba's capacity dispatch bit for bit as it was; and a reduced
granite ``ServeApp`` suspended and resumed under ``CACSService`` giving
the uninterrupted tokens.

Tolerances. Logits are compared relative to the reference's largest
logit. The float32 port differs from the float32 reference by
summation order alone (the chunked scan against the step-by-step one,
batched against per-token matmuls): under 1e-5 here, so the limit is
1e-4. The same port computed in bfloat16 lands near 1e-1 or beyond
(``test_tolerance_tells_bf16_from_f32``), three orders above the limit.
The scan's limit, 1e-5 of the largest output, is the float32 rounding
of a 64-step recurrence with room to spare; a bfloat16 scan misses it by
far.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import granite_ref as R
from _torch_unsplit_step import moe_apply as frozen_moe_apply
from repro_torch.ckpt import InMemoryStore
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.obs.telemetry import registry
from repro_torch.serve.engine import ServeApp

LOGIT_TOL = 1e-4
SCAN_TOL = 1e-5

GRANITE = get_config("granite-4.0-h-small")
CFG = dataclasses.replace(
    GRANITE, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=48, vocab_size=200, attn_every=4, attn_offset=1, attn_scale=0.0625,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, n_heads=8, head_dim=16,
                  n_groups=1, chunk=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, every=1,
                  shared_expert=True, capacity_factor=None),
    dtype="float32")


@pytest.fixture(autouse=True)
def _exact_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _params(cfg=CFG, seed=0):
    """Seeded params, the per-channel constants moved off their inits
    (which are ones and zeros) so that every term of the equations
    shows."""
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for block in params["stack"].values():
        for name, t in block.items():
            if name in ("dt_bias", "conv_b", "D", "gate_norm", "norm"):
                t.add_(0.1 * torch.randn(t.shape, generator=g).to(t.dtype))
    return model, params


def _tokens(B, S, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (B, S), generator=g)


def _forward(model, params, tokens):
    """The port's training forward, every position's logits."""
    with torch.no_grad():
        x, pos, _, _ = model._inputs(params, {"tokens": tokens},
                                     remat=False)
        x, _ = T.stack_forward(params["stack"], model.blocks, x, pos,
                               remat=False)
        x = L.rmsnorm(x, params["embed"]["final_norm"], model.cfg.norm_eps)
        return model._logits(params, x).float()


def _ref(params, tokens, cfg=CFG):
    return torch.stack([R.forward_logits(params, cfg, t) for t in tokens])


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_config_resolves_and_assigned_archs_unchanged():
    import repro.configs as ref_configs
    cfg = get_config("granite-4.0-h-small")
    assert (cfg.n_layers, cfg.attn_every, cfg.attn_offset) == (40, 10, 5)
    assert cfg.ssm.n_heads * cfg.ssm.head_dim == 2 * cfg.d_model
    assert cfg.moe.capacity_factor is None and cfg.moe.top_k == 10
    assert not cfg.use_rope and cfg.attn_scale == 1 / 128
    assert round(cfg.param_count() / 1e9, 2) == 32.21
    assert tuple(ASSIGNED_ARCHS) == tuple(ref_configs.ASSIGNED_ARCHS)
    assert "granite-4.0-h-small" not in ASSIGNED_ARCHS
    blocks, groups = T.build_group(cfg)
    mixers = [b.kind for b in blocks if b.kind != "moe"]
    assert groups == 4 and mixers.index("attn") == 5
    assert mixers.count("mamba2") == 9 and len(blocks) == 20


def test_reduced_granite_builds():
    """``reduced`` (the launchers' ``--reduced``) gives a Mamba-2 of 8
    heads and a top-k that its 4 experts hold."""
    cfg = reduced(GRANITE)
    model = build_model(cfg)
    assert cfg.moe.top_k == 2 and cfg.ssm.n_heads * cfg.ssm.head_dim == 256
    assert {b.kind for b in model.blocks} == {"attn", "mamba2", "moe"}


@pytest.mark.parametrize("S", [12, 40])
def test_full_forward_matches_reference(S):
    model, params = _params()
    tokens = _tokens(2, S)
    assert _gap(_forward(model, params, tokens), _ref(params, tokens)) \
        < LOGIT_TOL


@pytest.mark.parametrize("P,S", [(8, 20), (24, 40)])
def test_prefill_then_decode_matches_reference(P, S):
    """The prefill's last logits and each decode step's, through the
    cache (the scan's state and conv window handed over at P, over one
    chunk boundary or more), against the reference's full forward."""
    model, params = _params()
    tokens = _tokens(2, S)
    ref = _ref(params, tokens)
    logits, cache = model.prefill(params, {"tokens": tokens[:, :P]},
                                  cache_len=S + 4)
    assert cache["l0_mamba2"]["h"].shape == (2, 2, 8, 16, 16)
    assert cache["l0_mamba2"]["h"].dtype == torch.float32
    gaps = [_gap(logits.float(), ref[:, P - 1])]
    for t in range(P, S):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
        gaps.append(_gap(logits.float(), ref[:, t]))
    assert max(gaps) < LOGIT_TOL, gaps


def test_tolerance_tells_bf16_from_f32():
    """The port computed in bfloat16 fails the limit the float32 port
    meets."""
    model, params = _params()
    tokens = _tokens(2, 40)
    cfg16 = dataclasses.replace(CFG, dtype="bfloat16")
    p16 = {k: {kk: ({n: t.bfloat16() for n, t in v.items()}
                    if isinstance(v, dict) else v.bfloat16())
               for kk, v in tree.items()} for k, tree in params.items()}
    gap = _gap(_forward(build_model(cfg16), p16, tokens),
               _ref(params, tokens))
    assert gap > 10 * LOGIT_TOL


def _recurrence(x, dt, A, Bm, Cm, h):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t; y_t = C_t · h_t."""
    H, G = x.shape[2], Bm.shape[2]
    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("S,chunk,G", [(64, 16, 1), (50, 16, 2),
                                       (64, 64, 1), (7, 16, 2)])
def test_ssd_chunked_scan_equals_recurrence(S, chunk, G):
    g = torch.Generator().manual_seed(S + chunk + G)
    B, H, P, N = 2, 4, 8, 16
    x = torch.randn(B, S, H, P, generator=g)
    dt = F.softplus(torch.randn(B, S, H, generator=g) - 1.0)
    A = -torch.exp(torch.log(torch.arange(1, H + 1, dtype=torch.float32)))
    Bm, Cm = (torch.randn(B, S, G, N, generator=g) for _ in range(2))
    h0 = torch.randn(B, H, P, N, generator=g)
    y, h = SSM.ssd_scan(x, dt, A, Bm, Cm, chunk, h0)
    y_ref, h_ref = _recurrence(x, dt, A, Bm, Cm, h0)
    assert _gap(y, y_ref) < SCAN_TOL and _gap(h, h_ref) < SCAN_TOL
    yb, _ = SSM.ssd_scan(*(t.bfloat16().float() if t.is_floating_point()
                           else t for t in (x, dt, A, Bm, Cm)), chunk,
                         h0.bfloat16().float())
    assert _gap(yb, y_ref) > 10 * SCAN_TOL


def _skewed_moe():
    spec = M.MoESpec(64, CFG.moe, "swiglu", 1e-5, d_ff_shared=48)
    b = L.ParamBuilder(torch.Generator().manual_seed(3), torch.float32,
                       "cpu")
    M.moe_init(b, spec)
    p = b.params
    p["router"][:, 0] += 0.2          # tokens with a common offset lean
    return spec, p                    # to expert 0


def test_dropless_moe_matches_per_token_loop_under_skew():
    spec, p = _skewed_moe()
    x = torch.randn(2, 40, 64,
                    generator=torch.Generator().manual_seed(4)) + 2.0
    pairs0 = registry().value("moe.routed_pairs")
    rows0 = registry().value("moe.expert_rows")
    y, _ = M.moe_apply(p, spec, x)
    assert registry().value("moe.routed_pairs") - pairs0 == 2 * 40 * 2
    assert registry().value("moe.expert_rows") - rows0 == 2 * 40 * 2
    h = L.rmsnorm(x, p["norm"], 1e-5)
    probs = torch.softmax(h @ p["router"], -1)
    vals, idx = torch.topk(h @ p["router"], 2, dim=-1)
    gates = torch.softmax(vals, -1)
    # the skew: expert 0 is chosen by more pairs than any capacity holds
    cap = M.moe_capacity(40, dataclasses.replace(CFG.moe,
                                                 capacity_factor=1.25))
    assert int((idx == 0).sum(dim=(1, 2)).min()) > cap
    assert probs.argmax(-1).eq(0).float().mean() > 0.5
    want = torch.zeros_like(x)
    for b in range(2):
        for t in range(40):
            for k in range(2):
                e = int(idx[b, t, k])
                want[b, t] += gates[b, t, k] * R.swiglu(
                    h[b, t], p["we_g"][e], p["we_u"][e], p["we_d"][e])
    want = x + want + R.swiglu(h, p["ws_g"], p["ws_u"], p["ws_d"])
    assert _gap(y, want) < LOGIT_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capacity_moe_bit_equal_to_before(dtype):
    """jamba's capacity dispatch (and llama4's shared expert) as it was,
    frozen in ``tests/_torch_unsplit_step.py``: equal bit for bit."""
    for arch in ("jamba-v0.1-52b", "llama4-scout-17b-a16e"):
        cfg = reduced(get_config(arch))
        blk = next(b for b in T.build_group(cfg)[0] if b.kind == "moe")
        b = L.ParamBuilder(torch.Generator().manual_seed(5), dtype, "cpu")
        M.moe_init(b, blk.spec)
        x = torch.randn(2, 24, cfg.d_model,
                        generator=torch.Generator().manual_seed(6)).to(dtype)
        got, aux = M.moe_apply(b.params, blk.spec, x)
        want, aux0 = frozen_moe_apply(b.params, blk.spec, x)
        assert torch.equal(got, want) and torch.equal(aux, aux0), arch


def test_reference_matches_transformers():
    """The plain reference against transformers' granite on the same
    weights: the equations are granite's."""
    tf = pytest.importorskip("transformers")
    from transformers import (GraniteMoeHybridConfig,
                              GraniteMoeHybridForCausalLM)
    V, d, f, fs, E = CFG.vocab_size, CFG.d_model, 32, 48, 8
    hc = GraniteMoeHybridConfig(
        vocab_size=V, hidden_size=d, num_hidden_layers=CFG.n_layers,
        num_attention_heads=CFG.n_heads,
        num_key_value_heads=CFG.n_kv_heads, intermediate_size=f,
        shared_intermediate_size=fs, num_local_experts=E,
        num_experts_per_tok=2,
        layer_types=["mamba", "attention", "mamba", "mamba"] * 2,
        mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
        mamba_n_groups=1, mamba_d_conv=4, mamba_expand=2,
        mamba_chunk_size=16, position_embedding_type="nope",
        attention_multiplier=CFG.attn_scale, embedding_multiplier=12.0,
        residual_multiplier=0.22, logits_scaling=16.0,
        tie_word_embeddings=True, rms_norm_eps=CFG.norm_eps,
        attention_bias=False, mamba_conv_bias=True, mamba_proj_bias=False,
        initializer_range=0.1)
    torch.manual_seed(7)
    hf = GraniteMoeHybridForCausalLM(hc).float().eval()
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():               # move the per-channel constants
        for name, t in hf.named_parameters():
            if name.endswith(("dt_bias", "conv1d.bias", ".D", "norm.weight",
                              "layernorm.weight")):
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    Vp = build_model(CFG).vocab_padded
    emb = torch.zeros(Vp, d)
    emb[:V] = hf.model.embed_tokens.weight.detach()
    params = {"embed": {"embedding": emb,
                        "final_norm": hf.model.norm.weight.detach()},
              "stack": {}}
    stacks = {}
    for j, lay in enumerate(hf.model.layers):
        jj = j % CFG.attn_every
        kind = "attn" if jj == CFG.attn_offset else "mamba2"
        w = lambda m: m.weight.detach()
        if kind == "attn":
            a = lay.self_attn
            H, Hk, hd = CFG.n_heads, CFG.n_kv_heads, CFG.head_dim
            mix = {"wq": w(a.q_proj).t().reshape(d, H, hd),
                   "wk": w(a.k_proj).t().reshape(d, Hk, hd),
                   "wv": w(a.v_proj).t().reshape(d, Hk, hd),
                   "wo": w(a.o_proj).t().reshape(H, hd, d)}
        else:
            m = lay.mamba
            mix = {"in_proj": w(m.in_proj).t(),
                   "conv_w": w(m.conv1d)[:, 0].t(),
                   "conv_b": m.conv1d.bias.detach(),
                   "dt_bias": m.dt_bias.detach(), "A_log": m.A_log.detach(),
                   "D": m.D.detach(), "gate_norm": w(m.norm),
                   "out_proj": w(m.out_proj).t()}
        mix["norm"] = w(lay.input_layernorm)
        moe = lay.block_sparse_moe
        wi, wo = w(moe.input_linear), w(moe.output_linear)
        sh_i, sh_o = w(lay.shared_mlp.input_linear), \
            w(lay.shared_mlp.output_linear)
        ff = {"norm": w(lay.post_attention_layernorm),
              "router": w(moe.router.layer).t(),
              "we_g": wi[:, :f].transpose(1, 2),
              "we_u": wi[:, f:].transpose(1, 2),
              "we_d": wo.transpose(1, 2),
              "ws_g": sh_i[:fs].t(), "ws_u": sh_i[fs:].t(),
              "ws_d": sh_o.t()}
        for name, leaves in ((f"l{jj}_{kind}", mix), (f"l{jj}_moe", ff)):
            for k, t in leaves.items():
                stacks.setdefault(name, {}).setdefault(k, []).append(t)
    params["stack"] = {n: {k: torch.stack(ts) for k, ts in leaves.items()}
                       for n, leaves in stacks.items()}
    tokens = _tokens(2, 40)
    with torch.no_grad():
        want = hf(input_ids=tokens).logits.float()
    got = _ref(params, tokens)[..., :V]
    assert _gap(got, want) < LOGIT_TOL
    # and the port on those weights, through its own init's layout
    model = build_model(CFG)
    assert _gap(_forward(model, params, tokens)[..., :V], want) < LOGIT_TOL


def test_granite_serve_app_suspend_resume_under_cacs_service():
    """A reduced granite ``ServeApp`` under ``CACSService``, suspended
    mid-decode and resumed: the tokens of an uninterrupted run, so the
    image carried each Mamba-2 layer's ``h`` and ``conv`` and the KV
    cache."""
    from repro_torch.clusters import SnoozeBackend
    from repro_torch.core import ASR, CACSService, CheckpointPolicy, \
        CoordState
    kw = dict(batch=2, prompt_len=20, n_tokens=14, cache_len=40,
              device="cpu")
    straight = ServeApp(CFG, **kw)
    straight.start(None, None)
    straight._thread.join(timeout=120)
    want = straight.checkpoint_state()["tokens_out"]
    svc = CACSService({"snooze": SnoozeBackend(4)},
                      {"default": InMemoryStore()})
    try:
        cid = svc.submit(ASR(
            name="granite", n_vms=1, backend="snooze",
            app_factory=lambda: ServeApp(CFG, token_delay_s=0.05, **kw),
            policy=CheckpointPolicy(period_s=0, codec="raw")))
        coord = svc.wait_for_state(cid, CoordState.RUNNING, 60)
        deadline = time.monotonic() + 120
        while coord.app.generated < 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        svc.apps.suspend(cid)
        coord = svc.db.get(cid)
        assert coord.state == CoordState.SUSPENDED
        svc.apps.resume(cid)
        coord = svc.db.get(cid)
        app = coord.app
        assert app.restarts == 1 and 4 <= app.generated < kw["n_tokens"]
        for name in ("l0_mamba2", "l2_mamba2", "l3_mamba2"):
            assert app.cache is None or (
                app.cache[name]["h"].dtype == torch.float32)
        while not app.is_done():
            assert time.monotonic() < deadline and app.healthy()
            time.sleep(0.01)
        got = app.checkpoint_state()["tokens_out"]
    finally:
        svc.shutdown()
    np.testing.assert_array_equal(got, want)
