"""Training loop + the CACS-hosted TrainerApp (port of
``repro/train/trainer.py``).

``TrainerApp`` adapts a PyTorch training job to the CACS Application
protocol: it is checkpointed/suspended/migrated by the service without
knowing how, and its health hook reports NaN losses.

Two rules keep staged snapshots consistent, as jax's immutable arrays did
for the reference:
  * the train step is functional — it builds new param and moment tensors
    every step and never updates in place a tensor that a pinned snapshot
    may hold, so pinning references under the lock IS a consistent
    snapshot;
  * the trainer synchronises the step's stream before it swaps the state
    in, and the writer thread that resolves a snapshot works on the same
    (default) stream of the same device, so it never reads a tensor still
    being written.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.layout import PreEncodedLeaf, dtype_name
from repro_torch.ckpt.plane import PreEncodedChunk
from repro_torch.ckpt.snapshot import DeferredSnapshot, SnapshotHandle
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.qsnap import qsnap_encode_chunks
from repro_torch.models.model import Model, build_model
from repro_torch.obs.telemetry import SampleView, registry, unique_name
from repro_torch.sim.simtime import active_clock
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_state(model: Model, seed: int, device: Any = None) -> Dict[str, Any]:
    """Fresh {params, opt_state, step} on ``device``: ``cuda`` unless
    ``"cpu"`` is asked for; with no GPU and no explicit request this
    raises."""
    device = resolve_device(device)
    params = model.init(torch.Generator().manual_seed(seed), device)
    return {"params": params, "opt_state": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics).

    Functional: the returned state is made of new tensors; the input state
    is left as it was. Keys come back in sorted order, as the reference's
    jitted step returns them.
    """

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with torch.enable_grad():
            loss, aux = model.loss(params, batch, remat=remat)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt_state, om = adamw_update(
            opt_cfg, tree_unflatten(params, list(grads)), state["opt_state"],
            state["params"])
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return ({"opt_state": opt_state, "params": params,
                 "step": state["step"] + 1}, metrics)

    return train_step


def encode_state_on_device(tree: Any) -> Any:
    """Replace tensor leaves with device-encoded ``QS01`` payloads.

    Runs ``kernels.qsnap.qsnap_encode_chunks`` over every tensor leaf:
    quantization happens where the tensor lives (the CUDA kernel on a
    card, its plain version on the CPU), the D2H copy carries int8 codes +
    scales (~4x fewer bytes than f32), and the resulting
    ``PreEncodedLeaf``s flow through the writer's pass-through encode
    stage. Payloads are byte-identical to the host "int8" codec, so the
    image dedups and restores exactly like a host-compressed one.
    Non-tensor leaves (python scalars in iterator state) pass through and
    are framed losslessly by the host codec.
    """
    flat = tree_leaves(tree)
    idx = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
    payloads = qsnap_encode_chunks([flat[i] for i in idx])
    for i, payload in zip(idx, payloads):
        x = flat[i]
        chunk = PreEncodedChunk(payload, "int8")
        flat[i] = PreEncodedLeaf(
            shape=tuple(x.shape), dtype=dtype_name(x.dtype),
            chunks=[((0,) * x.dim(), tuple(x.shape), chunk)])
    return tree_unflatten(tree, flat)


class TrainerApp:
    """A real PyTorch training job hosted by CACS.

    Checkpoint state is {"state": {params, opt_state, step}, "data": iterator
    state} — restoring it resumes the exact token stream and optimizer
    trajectory (verified bit-exact in tests).

    ``device``: ``cuda`` unless ``"cpu"`` is asked for; with no GPU and no
    explicit request the constructor raises.
    """

    def __init__(self, cfg: ArchConfig, *, global_batch: int = 4,
                 seq_len: int = 64, n_steps: int = 50,
                 opt: Optional[AdamWConfig] = None, seed: int = 0,
                 remat: bool = True, device: Any = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.opt_cfg = opt or AdamWConfig(warmup_steps=5, total_steps=n_steps)
        self.n_steps = n_steps
        self.seed = seed
        self.pipeline = TokenPipeline(cfg, global_batch, seq_len, seed=seed)
        self._train_step = make_train_step(self.model, self.opt_cfg,
                                           remat=remat)
        self._state: Optional[Dict[str, Any]] = None
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_loss: float = float("nan")
        self.losses: list = []
        self.step_times: list = []
        # seconds the loop was blocked per snapshot pin: the registry
        # histogram is the store; ckpt_stalls (below) is a read-only view
        self._stall_hist = registry().histogram(
            unique_name("trainer.ckpt_stall_s"))
        self._host_step = 0                  # mirrors state["step"] host-side
        self.restarts = 0
        self._started = False

    def _bind_thread(self) -> None:
        """Make this app's card the calling thread's current device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # ---- Application protocol ------------------------------------------
    def start(self, ctx, restore_state: Optional[Any]) -> None:
        if restore_state is not None:
            state = tree_map(lambda x: x.to(self.device)
                             if isinstance(x, torch.Tensor) else x,
                             restore_state["state"])
            with self._state_lock:
                self._state = state
                self.pipeline.load_state_dict(restore_state["data"])
                self._host_step = int(restore_state["data"]["step"])
            self.restarts += 1
        elif self._state is None:
            self._state = init_state(self.model, self.seed, self.device)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._started = True

    def _run(self) -> None:
        self._bind_thread()
        clock = active_clock()
        while not self._stop.is_set() and self._host_step < self.n_steps:
            t0 = clock.now()
            batch = self.pipeline.next(self.device)
            new_state, metrics = self._train_step(self._state, batch)
            loss = float(metrics["loss"])
            # join the step OUTSIDE the lock — a concurrent snapshot
            # capture must never wait on device work
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            with self._state_lock:
                self._state = new_state
                self._host_step += 1         # swap + count: one atomic unit
            self.last_loss = loss
            self.losses.append(loss)
            self.step_times.append(clock.now() - t0)

    @property
    def ckpt_stalls(self) -> "SampleView":
        """Per-snapshot pin stalls, as a list-like view over the registry
        histogram."""
        return SampleView(self._stall_hist)

    @property
    def current_step(self) -> int:
        # host-side mirror: reading it never forces a device sync
        return self._host_step

    def checkpoint_state(self) -> Dict[str, Any]:
        with self._state_lock:
            state = self._state
            data = dict(self.pipeline.state_dict())
            data["step"] = self._host_step    # align stream with params
        return {"state": state, "data": data}

    def snapshot_async(self, *, step: Optional[int] = None,
                       codec: Optional[str] = None) -> SnapshotHandle:
        """Staged snapshot (Application protocol extension).

        Capture = pin the current state dict + iterator state under the
        lock (microseconds; the train step is functional and ``_run`` swaps
        whole dicts, so references ARE a consistent snapshot). The
        device→host copy — or, when ``codec`` selects int8, the on-device
        qsnap encode — happens in ``resolve()`` on the checkpoint writer
        thread, overlapped with the next step.
        """
        clock = active_clock()
        t0 = clock.now()
        with self._state_lock:
            state = self._state
            data = dict(self.pipeline.state_dict())
            data["step"] = host_step = self._host_step
        self._stall_hist.observe(clock.now() - t0)
        device_encode = codec in ("int8", "int8+zlib")

        def materialize():
            self._bind_thread()
            if device_encode:
                return {"state": encode_state_on_device(state), "data": data}
            return {"state": state, "data": data}

        return DeferredSnapshot(
            materialize, step=host_step if step is None else step)

    def healthy(self) -> bool:
        if not self.losses:
            return True
        return bool(np.isfinite(self.last_loss))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)

    def is_done(self) -> bool:
        return self.current_step >= self.n_steps

    def progress(self) -> float:
        return self.current_step / max(self.n_steps, 1)
