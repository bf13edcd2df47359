"""Serving engine: batched prefill + greedy decode over an in-place cache.

Port of ``repro/serve/engine.py``. Also hosts ``ServeApp`` — a
CACS-managed inference job whose checkpoint state is {params, decode
cache (KV and, for hybrid models, each Mamba layer's f32 ``h`` and conv
window; for xLSTM models each mLSTM layer's ``C``, ``n`` and conv window
and each sLSTM layer's ``c``, ``n``, ``h``, ``m``), generated tokens}:
suspending a *serving* job mid-generation and resuming it elsewhere is
the paper's job-swapping use case applied to inference. ``ServeApp``
draws its params on its own device and, as the reference's, feeds its
model tokens only: enc-dec and vlm models are served through
``Engine.generate``.

Prefill runs the flash-attention kernel and every decode step the
decode-attention kernel (``kernels.ops``; their plain versions on the
CPU). Where the reference donates the cache to a jitted decode and gets a
new one back, the port's decode writes slot ``pos`` of the live cache
and the recurrent states in place; ``ServeApp._capture`` therefore copies
the cache on the device under the lock before a snapshot pins it.

On a card, a model split over no mesh decodes by replaying one CUDA graph
of the step, captured once for each cache (``Engine.decode``): the host
enqueues three launches a step where the eager step takes hundreds. The
graph reads the token and ``pos`` from tensors on the card, so a replay
computes what the eager step computes at that ``pos``. A split model
(its collectives go through the host) and the CPU decode eagerly.

Telemetry: the prefill records a span ``prefill/<kind>`` for each decoder
block inside ``serve/prefill``, with its device time (``device_ms``, CUDA
events read after the prefill's own synchronize: ``Engine.settle``).
"""
from __future__ import annotations

import ctypes
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.layout import host_array
from repro_torch.ckpt.snapshot import DeferredSnapshot, SnapshotHandle
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models.model import Model, build_model
from repro_torch.obs.counts import CountSet
from repro_torch.obs.telemetry import SampleView, registry, unique_name
from repro_torch.obs.timer import PhaseTimer
from repro_torch.obs.trace import tracer
from repro_torch.sharding import specs as SH
from repro_torch.sim.simtime import active_clock
from repro_torch.tree import map_dicts, tree_leaves


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B,V] logits -> [B,1] int32 tokens."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


WARM_STEPS = 2          # eager steps on a copy of the cache before capture
_streams: Dict[int, torch.cuda.Stream] = {}
# one capture at a time in the process: every work enqueued on a stream
# while it captures joins the graph, and all captures share the side stream
_capture_lock = threading.Lock()


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a card for every capture and its warm-up: the
    kernels' per-stream buffers and cuBLAS's workspace are made in the
    warm-up, so none is allocated inside a capture."""
    s = _streams.get(device.index)
    if s is None:
        s = _streams[device.index] = torch.cuda.Stream(device)
    return s


def _graph_key(cache: Any, token: torch.Tensor) -> Tuple:
    """What a captured step bakes in: the token's shape and dtype, and
    the address, shape, strides and dtype of every cache tensor. A cache
    freed and another allocated at the same addresses, with the same
    layout, is read and written by a replay as the eager step would."""
    return (tuple(token.shape), token.dtype,
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in tree_leaves(cache)))


_libcuda: Optional[ctypes.PyDLL] = None


def _launch(graph: torch.cuda.CUDAGraph, device: torch.device) -> None:
    """Replay ``graph`` on the device's current stream through
    libcuda's ``cuGraphLaunch``, holding the GIL. ``CUDAGraph.replay``
    releases it, and on the H100 a replay that overlapped
    ``torch.profiler`` stopping in another thread deadlocked the two
    (PERF.md §6); with the GIL held they never overlap. The decode step
    draws no random numbers, so none of ``replay``'s generator bookkeeping
    is needed."""
    global _libcuda
    if _libcuda is None:
        lib = ctypes.PyDLL("libcuda.so.1")          # PyDLL: keeps the GIL
        lib.cuGraphLaunch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _libcuda = lib
    with build.on_device(device):
        err = _libcuda.cuGraphLaunch(graph.raw_cuda_graph_exec(),
                                     build.current_stream(device.index))
    if err:
        raise RuntimeError(f"decode step replay: cuGraphLaunch error {err}")


def _slots(cache: Any) -> int:
    """The KV caches' slots (a stacked [G, B, T, Hkv, hd] ``k``); no bound
    for a model without one."""
    return min((c["k"].shape[2] for c in cache.values() if "k" in c),
                default=sys.maxsize)


class _DecodeGraph:
    """One decode step captured as a CUDA graph over one cache. Inputs:
    the ``token`` [B,1] and ``pos`` (0-d int32) tensors it holds, refreshed
    on the card before each replay; output: the ``logits`` tensor the
    replay overwrites. ``graph`` is None where the capture failed: that
    cache decodes eagerly."""

    def __init__(self, key: Tuple, slots: int):
        self.key = key
        self.slots = slots
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Optional[CountSet] = None
        self.step: List[float] = []

    def capture(self, model: Model, params: Any, cache: Any,
                token: torch.Tensor, pos: int) -> None:
        """Warm up on a copy of the cache (a step writes slot ``pos`` and
        the recurrent states in place), then capture on the live one,
        which runs nothing. The warm-up's and the capture's counts
        (``Model.decode_counts``) are taken back: each replay adds one
        step's, exact while no other thread decodes during a capture."""
        with _capture_lock:
            self._capture(model, params, cache, token, pos)

    def _capture(self, model: Model, params: Any, cache: Any,
                 token: torch.Tensor, pos: int) -> None:
        dev = token.device
        stream = _capture_stream(dev)
        counts = model.decode_counts()
        saved = counts.read()
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                self.token = token.clone()
                self.pos = torch.full((), pos, dtype=torch.int32, device=dev)
                spare = map_dicts(torch.clone, cache)
                for _ in range(WARM_STEPS):
                    model.decode_step(params, spare, self.token, self.pos)
                del spare
                before = counts.read()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.logits, _ = model.decode_step(params, cache,
                                                       self.token, self.pos)
            self.step = [n - b for n, b in zip(counts.read(), before)]
            self.counts = counts
            self.graph = graph
            registry().inc("serve.decode_graph_captures")
        except Exception as e:                  # noqa: BLE001
            registry().inc("serve.decode_graph_fallbacks",
                           note=f"decode step not captured, runs eagerly: "
                                f"{type(e).__name__}: {e}")
        finally:
            torch.cuda.current_stream(dev).wait_stream(stream)
            counts.write(saved)

    def replay(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        self.token.copy_(token)
        self.pos.fill_(pos)
        _launch(self.graph, self.pos.device)
        self.counts.add(self.step)
        registry().inc("serve.decode_graph_replays")
        return self.logits


class Engine:
    """``trace_id`` is the job's, for the spans ``serve/prefill`` and
    ``serve/dispatch`` (the decode step enqueued; ``graph: 1`` where it
    replayed a captured step)."""

    def __init__(self, model: Model, params: Any, *, cache_len: int = 256,
                 trace_id: str = ""):
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.trace_id = trace_id
        self._graph: Optional[_DecodeGraph] = None
        self._timer: Optional[PhaseTimer] = None

    def prefill(self, batch: Dict[str, torch.Tensor]):
        """(last-position logits, cache). The blocks' spans get their
        ``device_ms`` at ``settle``, once the caller has synchronised."""
        tokens = next(iter(batch.values()))
        self._timer = PhaseTimer(tokens.device, cat="serve")
        with tracer().span("serve/prefill", cat="serve",
                           trace_id=self.trace_id):
            logits, cache = self.model.prefill(self.params, batch,
                                               cache_len=self.cache_len,
                                               timer=self._timer)
        return logits, cache

    def settle(self) -> None:
        """Set the last prefill's block spans' ``device_ms``: call once the
        prefill's work has finished on the device."""
        if self._timer is not None:
            self._timer.settle()
            self._timer = None

    def decode(self, cache, token, pos: int):
        """One step: (logits [B,V], cache), slot ``pos`` of ``cache`` and
        its recurrent states written in place. Where the step replays a
        graph (``_graph_for``), the logits are the graph's output tensor,
        valid until the next decode: consume them first, as ``ServeApp``
        and ``generate`` do."""
        with tracer().span("serve/dispatch", cat="serve",
                           trace_id=self.trace_id) as sp:
            g = self._graph_for(cache, token, pos)
            if g is None:
                return self.model.decode_step(self.params, cache, token, pos)
            sp.set("graph", 1)
            return g.replay(token, pos), cache

    def _graph_for(self, cache, token, pos: int) -> Optional[_DecodeGraph]:
        """The captured step for this cache and batch, captured now on
        first sight; None where the step runs eagerly: off the card, a
        model split over a mesh, a ``pos`` outside the cache (the eager
        step refuses it), a capture that failed."""
        if token.device.type != "cuda" or SH.active_axes() is not None:
            return None
        key = _graph_key(cache, token)
        g = self._graph
        if g is None or g.key != key:
            g = self._graph = None      # free the old graph's pool first
            g = _DecodeGraph(key, _slots(cache))
            if 0 <= pos < g.slots:
                g.capture(self.model, self.params, cache, token, pos)
                self._graph = g
        if g.graph is None or not 0 <= pos < g.slots:
            return None
        return g

    def generate(self, batch: Dict[str, torch.Tensor],
                 n_tokens: int) -> torch.Tensor:
        """Prefill the prompt then decode n_tokens greedily. Returns
        [B, n_tokens] int32. A vlm's prompt starts with its
        ``frontend_len`` patch embeddings, so its decode positions start
        past them; an enc-dec model's frames are the encoder's, not the
        decoder's."""
        cfg = self.model.cfg
        prompt_len = batch["tokens"].shape[1]
        if cfg.frontend is not None and cfg.family != "encdec":
            prompt_len += cfg.frontend_len
        logits, cache = self.prefill(batch)
        token = _greedy(logits)
        out = [token]
        for i in range(1, n_tokens):
            logits, cache = self.decode(cache, token, prompt_len + i - 1)
            token = _greedy(logits)
            out.append(token)
        return torch.cat(out, dim=1)


class ServeApp:
    """CACS-hosted batched-serving job (checkpointable mid-generation).

    ``device``: ``cuda`` unless ``"cpu"`` is asked for; with no GPU and no
    explicit request the constructor raises.
    """

    def __init__(self, cfg: ArchConfig, *, batch: int = 2,
                 prompt_len: int = 16, n_tokens: int = 64,
                 cache_len: int = 128, seed: int = 0,
                 token_delay_s: float = 0.0, device: Any = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.batch = batch
        self.prompt_len = prompt_len
        self.n_tokens = n_tokens
        self.cache_len = cache_len
        self.seed = seed
        self.token_delay_s = token_delay_s   # rate-limit (tests/demos)
        self.params: Any = None
        self.cache: Any = None
        self.tokens_out: List[np.ndarray] = []
        self.generated = 0
        self._last_token: Optional[torch.Tensor] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # signaled whenever the surrendered cache slot refills (or the
        # decode loop dies): _capture blocks on this instead of polling
        self._cond = threading.Condition(self._lock)
        # first decode-loop exception; healthy() flips False on it
        self._failure: Optional[BaseException] = None
        # seconds decode was blocked per snapshot pin: registry histogram
        # is the store; ckpt_stalls (below) is a read-only view
        self._stall_hist = registry().histogram(
            unique_name("serve.ckpt_stall_s"))
        self.restarts = 0
        self.trace_id = ""

    def _build(self):
        if self.params is None:
            self.params = self.model.init(
                torch.Generator(self.device).manual_seed(self.seed),
                self.device)
        self.engine = Engine(self.model, self.params,
                             cache_len=self.cache_len, trace_id=self.trace_id)

    def start(self, ctx, restore_state: Optional[Any]) -> None:
        self.trace_id = getattr(ctx, "trace_id", "")
        if restore_state is not None:
            on_dev = lambda t: t.to(self.device)
            with self._lock:
                self.params = map_dicts(on_dev, restore_state["params"])
                self.cache = map_dicts(on_dev, restore_state["cache"])
                self.generated = int(restore_state["generated"])
                self._last_token = on_dev(
                    torch.as_tensor(restore_state["last_token"]))
                tokens = restore_state["tokens_out"]
                if isinstance(tokens, torch.Tensor):
                    tokens = host_array(tokens)
                self.tokens_out = [np.asarray(tokens)] \
                    if self.generated else []
            self.restarts += 1
        self._build()
        self._stop.clear()
        self._failure = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _fail(self, e: BaseException, cache: Any = None) -> None:
        """End the loop on ``e``: ``healthy()`` turns false, a waiter
        wakes, and ``cache`` goes back into the slot (None where the
        prefill failed: there is no consistent cache to capture)."""
        with self._cond:
            self.cache = cache
            self._failure = e
            self._cond.notify_all()
        registry().inc("serve.decode_failures",
                       note=f"{type(e).__name__}: {e}")

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self.cache is None:
            rng = np.random.Generator(np.random.PCG64(self.seed))
            prompt = rng.integers(
                0, self.cfg.vocab_size, (self.batch, self.prompt_len)
            ).astype(np.int32)
            try:
                logits, cache = self.engine.prefill(
                    {"tokens": torch.from_numpy(prompt).to(self.device)})
                token = _greedy(logits)
                token_np = token.cpu().numpy()  # waits for the prefill
                self.engine.settle()
            except BaseException as e:             # noqa: BLE001
                self._fail(e)
                return
            with self._cond:
                self.cache = cache
                self._last_token = token
                self.tokens_out.append(token_np)
                self.generated = 1
                self._cond.notify_all()
        clock = active_clock()
        while not self._stop.is_set() and self.generated < self.n_tokens:
            if self.token_delay_s:
                clock.sleep(self.token_delay_s)
            pos = self.prompt_len + self.generated - 1
            tr = tracer()
            # one span a token, from taking the cache to publishing the
            # token: its end is the token's timestamp
            with tr.span("serve/step", cat="serve", trace_id=self.trace_id,
                         args={"pos": pos}):
                # the decode writes the cache in place: surrender the slot
                # so a capture never copies a cache a decode is writing
                with self._lock:
                    cache, token = self.cache, self._last_token
                    self.cache = None
                try:
                    logits, new_cache = self.engine.decode(cache, token, pos)
                    token = _greedy(logits)
                    with tr.span("serve/token_wait", cat="serve"):
                        token_np = token.cpu().numpy()  # waits for the decode
                except BaseException as e:         # noqa: BLE001
                    # Restore the surrendered slot: leaving it None would
                    # make every _capture (snapshot_async, suspend) block
                    # forever on a dead loop. A decode that failed half-way
                    # may have written slot ``pos`` of some layers; slots
                    # from ``pos`` on are never read before being written
                    # again, so the cache is still the last consistent
                    # state and a suspend issued after the fault swaps out
                    # cleanly.
                    self._fail(e, cache)
                    return
                with self._cond:
                    self.cache = new_cache
                    self._last_token = token
                    self.tokens_out.append(token_np)
                    self.generated += 1
                    self._cond.notify_all()

    def _capture(self) -> Dict[str, Any]:
        """Pin a consistent snapshot under the lock (waits out the window
        where the cache is surrendered to an in-flight decode).
        Params/tokens are references (never written); the KV cache is
        **copied on device** — the very next decode step writes the live
        cache in place, so a pinned reference would change under the
        writer thread. The copy is only enqueued (on the stream every
        decode uses, so it is ordered between two decodes), so the pin
        stall stays in microseconds.

        Blocks on a condition variable signaled when the slot refills —
        never on the installed clock: a virtual-time poll here would race
        the SimClock forward while the decode runs in wall time. The wait
        timeout is only a wall-clock backstop against a decode thread that
        dies without notifying."""
        with self._cond:
            while self.cache is None:
                if self._failure is not None:
                    raise RuntimeError(
                        "serve decode loop failed with the surrendered "
                        "cache unrecoverable") from self._failure
                self._cond.wait(timeout=0.1)
            return {
                "params": self.params,
                "cache": map_dicts(lambda t: t.clone(), self.cache),
                "generated": self.generated,
                "last_token": self._last_token,
                "tokens_out": list(self.tokens_out),
            }

    @staticmethod
    def _materialize(snap: Dict[str, Any], batch: int) -> Dict[str, Any]:
        out = dict(snap)
        out["tokens_out"] = (np.concatenate(snap["tokens_out"], axis=1)
                             if snap["tokens_out"]
                             else np.zeros((batch, 0), np.int32))
        return out

    def checkpoint_state(self) -> Dict[str, Any]:
        return self._materialize(self._capture(), self.batch)

    def snapshot_async(self, *, step: Optional[int] = None,
                       codec: Optional[str] = None) -> SnapshotHandle:
        """Staged snapshot: capture pins params/token references and an
        on-device copy of the cache (token-latency stall only while a
        decode holds the cache); the concat + any host copies run at
        ``resolve()`` on the writer thread. The KV cache stays lossless
        regardless of ``codec`` — quantizing it would perturb the
        generated stream, and suspend/resume guarantees the tokens are
        unchanged."""
        clock = active_clock()
        t0 = clock.now()
        snap = self._capture()
        self._stall_hist.observe(clock.now() - t0)
        return DeferredSnapshot(
            lambda: self._materialize(snap, self.batch),
            step=snap["generated"] if step is None else step)

    @property
    def ckpt_stalls(self) -> SampleView:
        """Per-snapshot pin stalls, as a list-like view over the registry
        histogram."""
        return SampleView(self._stall_hist)

    def healthy(self) -> bool:
        return self._failure is None

    def stop(self, join_s: float = 60.0) -> bool:
        """Stop the decode loop. Returns True when the thread LEAKED —
        the join timed out on a wedged decode (e.g. a hung device call).
        Leaks are counted in the ``serve.stop_timeouts`` registry counter
        with the last decode error as the note."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        thread = self._thread
        if thread is None:
            return False
        thread.join(timeout=join_s)
        if thread.is_alive():
            registry().inc(
                "serve.stop_timeouts",
                note=f"decode thread wedged after {join_s}s "
                     f"(last_error={self._failure!r})")
            return True
        return False

    def is_done(self) -> bool:
        return self.generated >= self.n_tokens

    def progress(self) -> float:
        return self.generated / max(self.n_tokens, 1)
