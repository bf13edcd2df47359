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
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.ckpt.layout import PreEncodedLeaf, dtype_name
from repro_torch.ckpt.plane import PreEncodedChunk
from repro_torch.ckpt.snapshot import DeferredSnapshot, SnapshotHandle
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.qsnap import qsnap_encode_chunks
from repro_torch.models.model import Model, build_model
from repro_torch.obs.telemetry import SampleView, registry, unique_name
from repro_torch.sharding.specs import (MeshAxes, distribute, dp_rows,
                                        full_tensor, local_slice, make_axes,
                                        map_dims, mesh_placements,
                                        param_specs, wrap_local)
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
                    axes: Optional[MeshAxes] = None, remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics).

    Functional: the returned state is made of new tensors; the input state
    is left as it was. Keys come back in sorted order, as the reference's
    jitted step returns them.

    With a ``mesh`` (``axes`` default ``make_axes(mesh)``) the state's
    leaves are DTensors laid out by ``shard_state``, and every rank of the
    mesh calls the step with the same global batch. The step all-gathers
    each param, computes loss and grads on this rank's rows of the batch
    (split over the ``dp`` axes), averages the grads and metrics over
    them, takes the clip norm over the whole averaged gradient, and runs
    the AdamW update on this rank's slices of params, grads and moments;
    the new leaves keep their placements. Compute is replicated over the
    model axis: only the state is sharded there. The loss is the mean of
    the shards' token means, which is the batch's when every shard holds
    as many target tokens (the pipeline's batches do). With one
    data-parallel rank no collective touches the numbers, and the step
    equals the single-process step bit for bit.
    """
    if mesh is not None:
        return _sharded_step(model, opt_cfg, mesh,
                             axes or make_axes(mesh), remat)

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


def _sharded_step(model: Model, opt_cfg: AdamWConfig, mesh: DeviceMesh,
                  axes: MeshAxes, remat: bool):
    names = tuple(mesh.mesh_dim_names)
    dp_dims = [names.index(a) for a in axes.dp
               if mesh.size(names.index(a)) > 1]
    n_dp = 1
    for i in dp_dims:
        n_dp *= mesh.size(i)

    def dp_mean(t: torch.Tensor) -> torch.Tensor:
        if not dp_dims:
            return t
        t = t.contiguous()
        for i in dp_dims:
            dist.all_reduce(t, group=mesh.get_group(i))
        return t / n_dp

    def local(tree):
        return tree_map(lambda t: t.to_local(), tree)

    def rewrap(tree, like):
        return tree_map(lambda t, d: wrap_local(t, d.device_mesh,
                                                d.placements, d.shape),
                        tree, like)

    def train_step(state, batch):
        full = tree_map(full_tensor, state["params"])
        lo, hi = dp_rows(batch["tokens"].shape[0], mesh, axes.dp)
        rows = {k: v[lo:hi] for k, v in batch.items()}
        params = tree_map(lambda p: p.detach().requires_grad_(), full)
        with torch.enable_grad():
            loss, aux = model.loss(params, rows, remat=remat)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        del params, full
        grads = tree_unflatten(state["params"], [dp_mean(g) for g in grads])
        gnorm = global_norm(grads)
        new_p, new_opt, om = adamw_apply(
            opt_cfg, tree_map(local_slice, grads, state["params"]),
            local(state["opt_state"]), local(state["params"]), gnorm)
        step = state["step"]
        metrics = {"loss": dp_mean(loss.detach()),
                   **{k: dp_mean(v.detach()) for k, v in aux.items()}, **om}
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
