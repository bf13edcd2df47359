"""The port's serving path on the CPU: against the JAX package's engine,
across the two packages' checkpoint images, and the ``tests/test_serve.py``
contracts held inside the port.

  * from the same (JAX) init and prompt, the port's ``Engine`` gives the
    JAX ``Engine``'s prefill and decode logits within 1e-4 (f32; the two
    sum in different orders), the same greedy tokens and cache leaves
    within 1e-4, for reduced ``repro-100m``, ``internlm2-1.8b``, the
    windowed ``gemma3-12b``, the MoE ``llama4-scout-17b-a16e``, the
    hybrid ``jamba-v0.1-52b`` (its Mamba ``h`` and ``conv`` caches too),
    ``xlstm-125m`` (its mLSTM and sLSTM states), ``seamless-m4t-medium``
    (encoder frames from a numpy seed; its cross-attention memory) and
    ``internvl2-2b`` (patch embeddings before the prompt, decode positions
    past them);
  * a JAX ``ServeApp`` state written mid-generation (by the JAX writer to
    a ``LocalFSStore``, or handed over through ``convert``) resumes in the
    port with the JAX uninterrupted run's tokens, for reduced repro-100m
    and xlstm and, through the image, for reduced jamba;
  * reduced jamba and xlstm ``ServeApp``s of the port suspended
    mid-generation resume with their uninterrupted tokens bit for bit;
  * inside the port, on its own SimClock: generate shapes, determinism,
    an unchanged token stream across snapshot_async + save_checkpoint +
    restore + start, a pinned snapshot that later decodes leave alone, a
    decode failure that restores the cache slot and flips health, a
    capture that blocks without advancing virtual time, and a stop
    timeout that counts the leaked thread;
  * the serving entry points land on the card unless the CPU is asked
    for, and raise without a GPU.
"""
import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import LocalFSStore as JLocalFSStore
from repro.ckpt import save_checkpoint as jsave_checkpoint
from repro.configs import get_config, reduced
from repro.models import build_model as jbuild_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeApp as JServeApp
from repro_torch.ckpt import (InMemoryStore, LocalFSStore, restore,
                              save_checkpoint)
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, serve_state_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.obs.telemetry import registry
from repro_torch.serve.engine import Engine, ServeApp
from repro_torch.sim.simtime import SimClock, active_clock, install_clock
from repro_torch.tree import leaves_with_path

ARCHS = ["repro-100m", "internlm2-1.8b", "gemma3-12b",
         "llama4-scout-17b-a16e", "jamba-v0.1-52b", "xlstm-125m",
         "seamless-m4t-medium", "internvl2-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch):
    return (dataclasses.replace(reduced(get_config(arch)), dtype="float32"),
            dataclasses.replace(treduced(tget_config(arch)),
                                dtype="float32"))


JCFG, CFG = _cfgs("repro-100m")
JAMBA_JCFG, JAMBA_CFG = _cfgs("jamba-v0.1-52b")
XLSTM_JCFG, XLSTM_CFG = _cfgs("xlstm-125m")


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
    """ServeApp's token_delay_s sleeps and stall stamps ride the port's
    active clock: run on a discrete-event SimClock, as the reference's
    serve suite does on its own."""
    clk = SimClock()
    prev = install_clock(clk)
    try:
        yield clk
    finally:
        clk.close()
        install_clock(prev)


def _prompt(cfg, B, S, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _frontend(cfg, B, seed=0):
    """An enc-dec model's encoder frames or a vlm's patch embeddings, by
    name, from a numpy seed; nothing for a tokens-only model."""
    extra = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
    if extra is None:
        return {}
    rng = np.random.Generator(np.random.PCG64(seed + 1))
    return {extra: (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                    * 0.02).astype(np.float32)}


def _wait(app, timeout=120):
    t0 = time.monotonic()
    while not app.is_done():
        assert app._thread.is_alive() or app.is_done(), "decode loop died"
        assert time.monotonic() - t0 < timeout, "serving did not finish"
        time.sleep(0.01)
    assert app.stop() is False
    return app


def _run(app, restore_state=None):
    app.start(None, restore_state)
    return _wait(app)


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    jcfg, cfg = _cfgs(arch)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    B, S, steps = 2, 12, 8
    F = cfg.frontend_len if cfg.family == "vlm" else 0  # patch slots first
    cache_len = F + S + steps + 1
    jeng = JEngine(jm, jparams, cache_len=cache_len)
    eng = Engine(build_model(cfg), params_from_jax(jax.device_get(jparams),
                                                   "cpu"),
                 cache_len=cache_len)
    prompt = {"tokens": _prompt(cfg, B, S), **_frontend(cfg, B)}
    jbatch = {k: jnp.asarray(v) for k, v in prompt.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in prompt.items()}
    before = registry().value(TL.WINDOW_REF_DECODES)
    jlogits, jcache = jeng.prefill(jbatch)
    logits, cache = eng.prefill(tbatch)
    for i in range(steps + 1):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if i == steps:
            break
        jlogits, jcache = jeng.decode(jcache, jtok, jnp.int32(F + S + i))
        logits, cache = eng.decode(cache, tok, F + S + i)
    jleaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    ours = leaves_with_path(cache)
    assert [p for p, _ in ours] == [tuple(k.key for k in p)
                                    for p, _ in jleaves]
    for (_, t), (_, j) in zip(ours, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    n_local = sum(1 for blk in eng.model.blocks
                  if blk.kind == "attn" and blk.spec.window is not None)
    assert registry().value(TL.WINDOW_REF_DECODES) - before == \
        n_local * eng.model.n_groups * steps
    np.testing.assert_array_equal(eng.generate(tbatch, 6).numpy(),
                                  np.asarray(jeng.generate(jbatch, 6)))


def _jax_run(n_tokens, jcfg=JCFG, **kw):
    app = JServeApp(jcfg, batch=2, prompt_len=8, n_tokens=n_tokens,
                    cache_len=24, **kw)
    app.start(None, None)
    while not app.is_done():
        time.sleep(0.01)
    app.stop()
    return app


@pytest.mark.parametrize("route", ["image", "convert"])
def test_jax_serving_state_resumes_in_port(route, tmp_path):
    """A JAX serving job stopped after 5 of 16 tokens is resumed by the
    port, which must produce the JAX uninterrupted run's 16 tokens."""
    want = _jax_run(16).checkpoint_state()["tokens_out"]
    half = _jax_run(5)
    if route == "image":
        jsave_checkpoint(JLocalFSStore(str(tmp_path)), "serve", 5,
                         half.checkpoint_state(), codec="raw")
        state, _ = restore(LocalFSStore(str(tmp_path)), "serve",
                           device="cpu")
    else:
        state = serve_state_from_jax(
            jax.device_get(half.checkpoint_state()), "cpu")
        assert isinstance(state["tokens_out"], np.ndarray)
    assert state["generated"] == 5
    app = _run(ServeApp(CFG, batch=2, prompt_len=8, n_tokens=16,
                        cache_len=24, device="cpu"), state)
    assert app.restarts == 1
    np.testing.assert_array_equal(app.checkpoint_state()["tokens_out"], want)


def test_jax_hybrid_serving_image_resumes_in_port(tmp_path):
    """A JAX jamba serving job stopped after 5 of 12 tokens, its image (KV
    cache, f32 Mamba ``h`` and conv windows) written by the JAX writer, is
    resumed by the port, which must produce the JAX uninterrupted run's
    12 tokens."""
    want = _jax_run(12, JAMBA_JCFG).checkpoint_state()["tokens_out"]
    jsave_checkpoint(JLocalFSStore(str(tmp_path)), "serve", 5,
                     _jax_run(5, JAMBA_JCFG).checkpoint_state(), codec="raw")
    state, _ = restore(LocalFSStore(str(tmp_path)), "serve", device="cpu")
    mamba = [c for name, c in state["cache"].items() if "mamba" in name]
    assert len(mamba) == 7
    assert all(c["h"].dtype == torch.float32 for c in mamba)
    app = _run(ServeApp(JAMBA_CFG, batch=2, prompt_len=8, n_tokens=12,
                        cache_len=24, device="cpu"), state)
    np.testing.assert_array_equal(app.checkpoint_state()["tokens_out"], want)


@pytest.mark.parametrize("route", ["image", "convert"])
def test_jax_xlstm_serving_state_resumes_in_port(route, tmp_path):
    """A JAX xlstm serving job stopped after 5 of 12 tokens, its state
    (each mLSTM layer's f32 ``C`` and ``n`` and conv window, each sLSTM
    layer's f32 ``c``, ``n``, ``h``, ``m``) written by the JAX writer or
    handed over through ``convert``, is resumed by the port, which must
    produce the JAX uninterrupted run's 12 tokens."""
    want = _jax_run(12, XLSTM_JCFG).checkpoint_state()["tokens_out"]
    half = _jax_run(5, XLSTM_JCFG).checkpoint_state()
    if route == "image":
        jsave_checkpoint(JLocalFSStore(str(tmp_path)), "serve", 5, half,
                         codec="raw")
        state, _ = restore(LocalFSStore(str(tmp_path)), "serve",
                           device="cpu")
    else:
        state = serve_state_from_jax(jax.device_get(half), "cpu")
    assert sorted(state["cache"]) == ["l0_mlstm", "l1_slstm"]
    assert sorted(state["cache"]["l0_mlstm"]) == ["C", "conv", "n"]
    assert sorted(state["cache"]["l1_slstm"]) == ["c", "h", "m", "n"]
    assert all(t.dtype == torch.float32
               for name, c in state["cache"].items()
               for kk, t in c.items() if kk != "conv")
    app = _run(ServeApp(XLSTM_CFG, batch=2, prompt_len=8, n_tokens=12,
                        cache_len=24, device="cpu"), state)
    np.testing.assert_array_equal(app.checkpoint_state()["tokens_out"], want)


# ---------------------------------------------------------------------------
# The tests/test_serve.py contracts, inside the port
# ---------------------------------------------------------------------------

class _PausingServe(ServeApp):
    """ServeApp whose decode loop stops itself once ``stop_at`` tokens
    exist: a suspend at a known point."""

    def __init__(self, *args, stop_at=4, **kwargs):
        super().__init__(*args, **kwargs)
        self._stop_at = stop_at

    def _build(self):
        super()._build()
        real = self.engine.decode

        def decode(cache, token, pos):
            if self.generated >= self._stop_at:
                self._stop.set()
            return real(cache, token, pos)
        self.engine.decode = decode


class _FlakyServe(ServeApp):
    """ServeApp whose decode raises once ``fail_at`` tokens exist."""

    def __init__(self, *args, fail_at=4, **kwargs):
        super().__init__(*args, **kwargs)
        self._fail_at = fail_at

    def _build(self):
        super()._build()
        real = self.engine.decode

        def decode(cache, token, pos):
            if self.generated >= self._fail_at:
                raise RuntimeError("chaos: device lost mid-decode")
            return real(cache, token, pos)
        self.engine.decode = decode


class _GatedServe(ServeApp):
    """ServeApp whose decode parks on a wall event while it holds the
    surrendered cache — reproduces that window at will."""

    def __init__(self, *args, gate_at=2, **kwargs):
        super().__init__(*args, **kwargs)
        self._gate_at = gate_at
        self.entered = threading.Event()
        self.release = threading.Event()

    def _build(self):
        super()._build()
        real = self.engine.decode

        def decode(cache, token, pos):
            if self.generated >= self._gate_at and not self.release.is_set():
                self.entered.set()
                self.release.wait(30)
            return real(cache, token, pos)
        self.engine.decode = decode


def _app(cls=ServeApp, **kw):
    kw = {"batch": 1, "prompt_len": 8, "n_tokens": 24, "cache_len": 40,
          **kw}
    return cls(CFG, device="cpu", **kw)


def test_engine_generate_shapes():
    model = build_model(CFG)
    engine = Engine(model, model.init(torch.Generator().manual_seed(0),
                                      "cpu"), cache_len=48)
    out = engine.generate({"tokens": torch.ones((2, 16), dtype=torch.int32)},
                          8)
    assert out.shape == (2, 8)
    assert out.dtype == torch.int32
    assert int(out.max()) < model.vocab_padded


def test_generate_deterministic():
    model = build_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": torch.from_numpy(_prompt(CFG, 1, 16))}
    e1 = Engine(model, params, cache_len=48)
    e2 = Engine(model, params, cache_len=48)
    assert torch.equal(e1.generate(toks, 8), e2.generate(toks, 8))


def test_serve_app_suspend_resume_token_stream_unchanged():
    """Job-swapping applied to inference: the interrupted stream equals the
    uninterrupted one."""
    ref_tokens = _run(_app()).checkpoint_state()["tokens_out"]
    paused = _app(_PausingServe, stop_at=4, token_delay_s=0.1)
    paused.start(None, None)
    paused._thread.join(timeout=60)
    assert not paused._thread.is_alive()
    assert paused.generated == 5 < paused.n_tokens
    handle = paused.snapshot_async()
    assert handle.step == 5 and len(paused.ckpt_stalls) == 1
    store = InMemoryStore()
    save_checkpoint(store, "serve", handle.step, handle, codec="raw")
    state, _ = restore(store, "serve", device="cpu")
    resumed = _run(_app(token_delay_s=0.1), state)
    assert resumed.restarts == 1
    np.testing.assert_array_equal(
        resumed.checkpoint_state()["tokens_out"], ref_tokens)


def test_hybrid_serve_app_suspend_resume_token_stream_unchanged():
    """A reduced jamba server suspended after 5 tokens: its image holds the
    KV cache, each Mamba layer's f32 ``h`` and conv window, and the
    resumed stream equals the uninterrupted one bit for bit."""
    kw = dict(batch=2, prompt_len=8, n_tokens=12, cache_len=24,
              device="cpu")
    ref_tokens = _run(ServeApp(JAMBA_CFG, **kw)).checkpoint_state()[
        "tokens_out"]
    paused = _PausingServe(JAMBA_CFG, stop_at=4, token_delay_s=0.1, **kw)
    paused.start(None, None)
    paused._thread.join(timeout=60)
    assert not paused._thread.is_alive() and paused.generated == 5
    store = InMemoryStore()
    save_checkpoint(store, "serve", 5, paused.snapshot_async(), codec="raw")
    state, _ = restore(store, "serve", device="cpu")
    live = paused.checkpoint_state()["cache"]
    for name, c in state["cache"].items():
        for kk, t in c.items():
            assert torch.equal(t, live[name][kk]), (name, kk)
    assert state["cache"]["l1_mamba"]["h"].dtype == torch.float32
    resumed = _run(ServeApp(JAMBA_CFG, **kw), state)
    np.testing.assert_array_equal(
        resumed.checkpoint_state()["tokens_out"], ref_tokens)


def test_xlstm_serve_app_suspend_resume_token_stream_unchanged():
    """A reduced xlstm server suspended after 5 tokens: its image holds
    the recurrent states as they were at the pin, and the resumed stream
    equals the uninterrupted one bit for bit."""
    kw = dict(batch=2, prompt_len=8, n_tokens=12, cache_len=24,
              device="cpu")
    ref_tokens = _run(ServeApp(XLSTM_CFG, **kw)).checkpoint_state()[
        "tokens_out"]
    paused = _PausingServe(XLSTM_CFG, stop_at=4, token_delay_s=0.1, **kw)
    paused.start(None, None)
    paused._thread.join(timeout=60)
    assert not paused._thread.is_alive() and paused.generated == 5
    store = InMemoryStore()
    save_checkpoint(store, "serve", 5, paused.snapshot_async(), codec="raw")
    state, _ = restore(store, "serve", device="cpu")
    live = paused.checkpoint_state()["cache"]
    for name, c in state["cache"].items():
        for kk, t in c.items():
            assert torch.equal(t, live[name][kk]), (name, kk)
    assert state["cache"]["l0_mlstm"]["C"].dtype == torch.float32
    resumed = _run(ServeApp(XLSTM_CFG, **kw), state)
    np.testing.assert_array_equal(
        resumed.checkpoint_state()["tokens_out"], ref_tokens)


def test_snapshot_holds_a_copy_of_the_cache():
    """Decode writes the live cache in place: a pinned snapshot must keep
    the cache as it was at the pin."""
    app = _app(_PausingServe, stop_at=3)
    app.start(None, None)
    app._thread.join(timeout=60)
    handle = app.snapshot_async()
    pinned = {k: {kk: t.clone() for kk, t in c.items()}
              for k, c in app.cache.items()}
    app._stop_at = app.n_tokens
    _run(app)                                   # writes further slots
    got = handle.resolve()["cache"]
    for name, c in pinned.items():
        for kk, t in c.items():
            assert torch.equal(got[name][kk], t)
            assert not torch.equal(app.cache[name][kk], t)


def test_decode_failure_restores_cache_and_flips_health():
    before = registry().value("serve.decode_failures", 0.0)
    app = _app(_FlakyServe, fail_at=3)
    app.start(None, None)
    app._thread.join(timeout=30)
    assert not app._thread.is_alive(), "decode thread should have died"
    assert app.healthy() is False
    assert app.cache is not None, "surrendered slot must be restored"
    state = app.checkpoint_state()
    assert state["generated"] == 3
    assert state["tokens_out"].shape == (1, 3)
    assert registry().value("serve.decode_failures", 0.0) == before + 1
    assert app.stop() is False


def test_capture_blocks_without_advancing_virtual_time(monkeypatch):
    """The capture thread waits on the condition variable while a decode
    holds the cache — it never sleeps on the installed clock."""
    app = _app(_GatedServe, gate_at=2)
    app.start(None, None)
    try:
        assert app.entered.wait(30), "decode never reached the gate"
        clock = active_clock()
        sleeper_idents = []
        real_sleep = clock.sleep

        def spy(dt):
            sleeper_idents.append(threading.get_ident())
            return real_sleep(dt)
        monkeypatch.setattr(clock, "sleep", spy)
        got = {}

        def grab():
            got["state"] = app.checkpoint_state()
        t = threading.Thread(target=grab, daemon=True)
        t.start()
        time.sleep(0.3)          # wall time: capture must still be pinned
        assert t.is_alive(), "capture returned while a decode held the cache"
        app.release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert got["state"]["generated"] >= 2
        assert t.ident not in sleeper_idents, \
            "capture slept on the installed clock while a decode held it"
    finally:
        app.release.set()
        app.stop()


def test_stop_timeout_counts_leaked_decode_thread():
    before = registry().value("serve.stop_timeouts", 0.0)
    app = _app(_GatedServe, gate_at=2)
    app.start(None, None)
    try:
        assert app.entered.wait(30), "decode never reached the gate"
        assert app.stop(join_s=0.2) is True
        assert registry().value("serve.stop_timeouts", 0.0) == before + 1
    finally:
        app.release.set()
        app._thread.join(timeout=30)
    assert not app._thread.is_alive()
    assert app.stop() is False


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["ServeApp", "Model.init_cache",
                                   "serve_state_from_jax", "launch.serve"])
def test_serving_entry_points_need_a_device_or_an_explicit_cpu(monkeypatch,
                                                               entry):
    calls = {
        "ServeApp": lambda: ServeApp(CFG),
        "Model.init_cache": lambda: build_model(CFG).init_cache(1, 8),
        "serve_state_from_jax": lambda: serve_state_from_jax(
            {"generated": 1, "tokens_out": np.zeros((1, 1), np.int32),
             "last_token": np.zeros((1, 1), np.int32)}),
        "launch.serve": launch_serve.main,
    }
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_launch_serve_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--reduced", "--device", "cpu", "--batch", "2",
        "--prompt-len", "8", "--tokens", "4"])
    launch_serve.main()
    out = capsys.readouterr().out
    assert "generated (2, 4) on cpu" in out
