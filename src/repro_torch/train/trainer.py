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

import contextlib
import threading
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.ckpt.layout import PreEncodedLeaf, dtype_name
from repro_torch.ckpt.plane import PreEncodedChunk
from repro_torch.ckpt.snapshot import DeferredSnapshot, SnapshotHandle
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.qsnap import qsnap_encode_chunks
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import remat_policy
from repro_torch.obs.telemetry import SampleView, registry, unique_name
from repro_torch.obs.timer import PhaseTimer
from repro_torch.obs.trace import tracer
from repro_torch.sharding.specs import (MeshAxes, activation_sharding,
                                        distribute, dp_all_reduce, dp_slice,
                                        make_axes, map_dims,
                                        mesh_placements, param_specs,
                                        part_of_gathered, tp_all_reduce,
                                        tp_rank, wrap_local)
from repro_torch.sim.simtime import active_clock
from repro_torch.train.optimizer import (AdamWConfig, adamw_apply,
                                         adamw_init, opt_state_dims)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_state(model: Model, seed: int, device: Any = None) -> Dict[str, Any]:
    """Fresh {params, opt_state, step} on ``device``: ``cuda`` unless
    ``"cpu"`` is asked for; with no GPU and no explicit request this
    raises."""
    device = resolve_device(device)
    params = model.init(torch.Generator().manual_seed(seed), device)
    return {"params": params, "opt_state": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_dims(model: Model) -> Dict[str, Any]:
    pd = model.param_dims()
    return {"params": pd, "opt_state": opt_state_dims(pd), "step": ()}


def shard_state(model: Model, state: Dict[str, Any], mesh: DeviceMesh,
                axes: MeshAxes) -> Dict[str, Any]:
    """A whole train state every rank holds -> DTensor leaves on ``mesh``,
    laid out by ``param_specs(state_dims(model), state, axes)``."""
    specs = param_specs(state_dims(model), state, axes)
    return map_dims(lambda spec, t: distribute(
        t, mesh, mesh_placements(spec, mesh)), specs, state)


def _split_over(dt: DTensor, keep) -> bool:
    """Whether ``dt`` is split over a mesh dim that ``keep`` names."""
    names = dt.device_mesh.mesh_dim_names
    return any(isinstance(p, Shard) and names[i] in keep
               for i, p in enumerate(dt.placements))


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    mesh: Optional[DeviceMesh] = None,
                    axes: Optional[MeshAxes] = None,
                    remat: Union[bool, str] = True,
                    timer: Optional[PhaseTimer] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    Functional: the returned state is made of new tensors; the input state
    is left as it was. Keys come back in sorted order, as the reference's
    jitted step returns them. The step records the spans
    ``train/forward``, ``train/backward`` and ``train/optimizer`` through
    ``timer`` (a ``PhaseTimer`` of the step's device; without one, spans
    alone).

    With a ``mesh`` (``axes`` default ``make_axes(mesh)``) the state's
    leaves are DTensors laid out by ``shard_state``, every rank calls the
    step with the same global batch, and the step runs under
    ``activation_sharding(axes, mesh)`` on this rank's rows and its view
    of the params (``Model.local_params``). Each rank's loss is its rows'
    Σ nll·mask over the batch's count of targets plus the batch's MoE
    aux, so the gradients summed over the data ranks are the batch's, and
    the reported ``loss`` and ``ce`` are the batch's masked mean, as one
    process gives. The clip norm is the whole gradient's, and AdamW
    updates this rank's slices. With a model axis the split reduces in
    another order than one process, so the numbers agree with it within
    f32 rounding, not bit for bit.

    ``remat`` is ``model.loss``'s: ``True``, ``False`` or ``"save_moe"``
    (``transformer.stack_forward``); another string raises ``ValueError``
    here.
    """
    remat = remat_policy(remat)
    phase = (timer or PhaseTimer("cpu")).phase
    if mesh is None:
        split = contextlib.nullcontext
    else:
        axes = axes or make_axes(mesh)
        split = lambda: activation_sharding(axes, mesh)     # noqa: E731

    def train_step(state, batch):
        held = tree_leaves(state["params"])
        with split():
            lo, hi = dp_slice(batch["tokens"].shape[0])
            rows = {k: v[lo:hi] for k, v in batch.items()}
            keep = model.split_axes()
            params = tree_map(lambda t: t.detach().requires_grad_(),
                              model.local_params(state["params"]))
            with torch.enable_grad():
                with phase("train/forward"):
                    loss, aux = model.loss(params, rows, remat=remat)
                with phase("train/backward"):
                    grads = torch.autograd.grad(loss, tree_leaves(params))
                    grads = [dp_all_reduce(g) for g in grads]
            del params
            loss, ce = loss.detach(), aux["ce"].detach()
            mine = state
            with phase("train/optimizer"):
                # a leaf whole on every model rank counts once
                first = tp_rank() == 0
                gnorm = torch.sqrt(tp_all_reduce(sum(
                    torch.sum(torch.square(g.float()))
                    for g, t in zip(grads, held)
                    if first or _split_over(t, keep))))
                if mesh is not None:
                    grads = [part_of_gathered(g, t, keep)
                             for g, t in zip(grads, held)]
                    mine = tree_map(lambda t: t.to_local(), state)
                new_p, new_opt, om = adamw_apply(
                    opt_cfg, tree_unflatten(mine["params"], grads),
                    mine["opt_state"], mine["params"], gnorm)
            new = {"opt_state": new_opt, "params": new_p,
                   "step": mine["step"] + 1}
            if mesh is not None:
                new = tree_map(lambda t, d: wrap_local(
                    t, d.device_mesh, d.placements, d.shape), new, state)
                # the loss is this rank's CE share plus the batch's aux
                # term: swap the share for the batch's CE
                share, ce = ce, dp_all_reduce(ce)
                loss = loss + (ce - share)
        return new, {"loss": loss, "ce": ce,
                     "moe_aux": aux["moe_aux"].detach(), **om}

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
    are framed losslessly by the host codec, and so do DTensor leaves, as
    the reference leaves multi-device arrays to the host path: the writer
    stages each rank's unique shards and encodes them there, into the same
    bytes.
    """
    flat = tree_leaves(tree)
    idx = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)
           and not isinstance(x, DTensor)]
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
                 remat: Union[bool, str] = True, device: Any = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.opt_cfg = opt or AdamWConfig(warmup_steps=5, total_steps=n_steps)
        self.n_steps = n_steps
        self.seed = seed
        self.pipeline = TokenPipeline(cfg, global_batch, seq_len, seed=seed)
        self._timer = PhaseTimer(self.device)
        self._train_step = make_train_step(self.model, self.opt_cfg,
                                           remat=remat, timer=self._timer)
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
        self.trace_id = ""

    def _bind_thread(self) -> None:
        """Make this app's card the calling thread's current device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # ---- Application protocol ------------------------------------------
    def start(self, ctx, restore_state: Optional[Any]) -> None:
        self.trace_id = getattr(ctx, "trace_id", "")
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
            tr = tracer()
            with tr.span("train/step", cat="train", trace_id=self.trace_id,
                         args={"step": self._host_step}):
                with tr.span("train/batch", cat="train"):
                    batch = self.pipeline.next(self.device)
                new_state, metrics = self._train_step(self._state, batch)
                # join the step OUTSIDE the lock — a concurrent snapshot
                # capture must never wait on device work
                with tr.span("train/sync", cat="train"):
                    loss = float(metrics["loss"])
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                self._timer.settle()
                with self._state_lock:
                    self._state = new_state
                    self._host_step += 1     # swap + count: one atomic unit
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
