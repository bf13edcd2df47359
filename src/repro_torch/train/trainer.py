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
                                        distribute, dp_all_reduce, dp_rows,
                                        make_axes, map_dims,
                                        mesh_placements, param_specs,
                                        part_of_gathered, tp_all_reduce,
                                        tp_rank, wrap_local)
from repro_torch.sim.simtime import active_clock
from repro_torch.train.optimizer import (AdamWConfig, adamw_apply,
                                         adamw_init, adamw_update,
                                         global_norm, opt_state_dims)
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


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    mesh: Optional[DeviceMesh] = None,
                    axes: Optional[MeshAxes] = None,
                    remat: Union[bool, str] = True,
                    timer: Optional[PhaseTimer] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    Functional: the returned state is made of new tensors; the input state
    is left as it was. Keys come back in sorted order, as the reference's
    jitted step returns them.

    With a ``mesh`` (``axes`` default ``make_axes(mesh)``) the state's
    leaves are DTensors laid out by ``shard_state``, and every rank of the
    mesh calls the step with the same global batch. The step all-gathers
    each param over the data-parallel (and FSDP) mesh dims only, keeping
    its slice on the model axis, and runs the forward under
    ``activation_sharding(axes, mesh)``: this rank's rows of the batch
    (split over the ``dp`` axes), its slices of heads, ``ff``, vocab
    (``tp``) and experts (``ep``), one all-reduce after each attention
    and MLP block, and its channels of the Mamba and xLSTM blocks. Each
    rank's loss is its rows' Σ nll·mask over the batch's count of
    targets (all-reduced over the data ranks) plus the batch's MoE aux,
    so its gradient is its rows' share, and the shares are summed over
    the data ranks: the reported ``loss`` and ``ce`` are the batch's
    masked mean, as one process gives. Gradients of leaves split over the
    model axis are already this rank's; those of leaves whole on every
    model rank are complete there (``specs.copy_to_tp``'s backward sums
    their partial gradients). The clip norm is the norm of the whole
    gradient (the squares of the model-axis slices summed once), and the
    AdamW update runs on this rank's slices of params, grads and moments;
    the new leaves keep their placements. With a model axis of size 1 no
    leaf is split there and the step sums over the data ranks alone; the
    split reduces in another order than one process, so with a model
    axis the numbers agree with one process within f32 rounding, not bit
    for bit.

    ``remat`` is ``model.loss``'s: ``True`` (each group remat'd whole),
    ``False``, or ``"save_moe"`` (each MoE layer's boundary tensors kept
    for the backward; ``transformer.stack_forward``); another string
    raises ``ValueError`` here.

    The one-process step records the spans ``train/forward``,
    ``train/backward`` and ``train/optimizer`` through ``timer`` (a
    ``PhaseTimer`` of the step's device; without one, spans alone).
    """
    remat = remat_policy(remat)
    if mesh is not None:
        return _sharded_step(model, opt_cfg, mesh,
                             axes or make_axes(mesh), remat)
    phase = (timer or PhaseTimer("cpu")).phase

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with torch.enable_grad():
            with phase("train/forward"):
                loss, aux = model.loss(params, batch, remat=remat)
            with phase("train/backward"):
                grads = torch.autograd.grad(loss, tree_leaves(params))
        with phase("train/optimizer"):
            params, opt_state, om = adamw_update(
                opt_cfg, tree_unflatten(params, list(grads)),
                state["opt_state"], state["params"])
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return ({"opt_state": opt_state, "params": params,
                 "step": state["step"] + 1}, metrics)

    return train_step


def _sharded_step(model: Model, opt_cfg: AdamWConfig, mesh: DeviceMesh,
                  axes: MeshAxes, remat: Union[bool, str]):
    names = tuple(mesh.mesh_dim_names)
    model_split = any(mesh.size(names.index(a)) > 1
                      for a in {axes.tp, axes.ep} - {None})

    def rewrap(tree, like):
        return tree_map(lambda t, d: wrap_local(t, d.device_mesh,
                                                d.placements, d.shape),
                        tree, like)

    def split_on_model(dt: DTensor, keep) -> bool:
        return any(isinstance(p, Shard) and names[i] in keep
                   for i, p in enumerate(dt.placements))

    def train_step(state, batch):
        lo, hi = dp_rows(batch["tokens"].shape[0], mesh, axes.dp)
        rows = {k: v[lo:hi] for k, v in batch.items()}
        held = tree_leaves(state["params"])
        with activation_sharding(axes, mesh):
            keep = model.split_axes()
            params = tree_map(lambda t: t.detach().requires_grad_(),
                              model.local_params(state["params"]))
            with torch.enable_grad():
                loss, aux = model.loss(params, rows, remat=remat)
                grads = torch.autograd.grad(loss, tree_leaves(params))
            del params
            grads = [dp_all_reduce(g) for g in grads]
            if model_split:
                first = tp_rank() == 0
                sq = sum(torch.sum(torch.square(g.float()))
                         for g, t in zip(grads, held)
                         if first or split_on_model(t, keep))
                gnorm = torch.sqrt(tp_all_reduce(sq))
            else:
                gnorm = global_norm(grads)
            grads = [part_of_gathered(g, t, keep)
                     for g, t in zip(grads, held)]
            # the loss is this rank's CE share plus the batch's aux term:
            # swap the share for the batch's CE
            ce = dp_all_reduce(aux["ce"].detach())
            loss = loss.detach() + (ce - aux["ce"].detach())
        new_p, new_opt, om = adamw_apply(
            opt_cfg, tree_unflatten(state["params"], grads),
            tree_map(lambda t: t.to_local(), state["opt_state"]),
            tree_map(lambda t: t.to_local(), state["params"]), gnorm)
        step = state["step"]
        metrics = {"loss": loss, "ce": ce,
                   "moe_aux": aux["moe_aux"].detach(), **om}
        return ({"opt_state": rewrap(new_opt, state["opt_state"]),
                 "params": rewrap(new_p, state["params"]),
                 "step": wrap_local(step.to_local() + 1, step.device_mesh,
                                    step.placements, step.shape)}, metrics)

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
