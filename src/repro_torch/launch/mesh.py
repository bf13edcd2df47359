"""Meshes and multi-process runs for the port's distributed layer (port of
``make_test_mesh`` in ``repro/launch/mesh.py``).

``make_test_mesh`` lays the ranks of an initialized process group out as
``arange(world).reshape(shape)`` under named dims, the device order of
the reference's ``make_test_mesh`` (its first devices, reshaped).
``make_production_mesh`` lays the first 256 ranks out as (16, 16)
``("data", "model")``, or 512 as (2, 16, 16) ``("pod", "data",
"model")``, the reference's production meshes. ``fake_world(n)`` starts
a world of ``n`` ranks on torch's ``fake`` backend, in which one process
plays one rank and every collective completes at once without moving
data: the dry run's counterpart of the reference's 512 forced host
devices (``XLA_FLAGS`` before jax starts). A mesh of ``meta`` tensors
lives on a ``cpu`` mesh.

``spawn(fn, world, *args)`` runs ``fn(rank, world, *args)`` in ``world``
fresh processes joined by one process group, and returns the ranks'
results in rank order::

    results = spawn(my_rank_fn, 4, cfg, timeout=300)

Each rank meets the others through a file in a temporary directory (no
port to collide with when test files run in parallel), runs torch on one
intra-op thread, and hands back a picklable result (numpy arrays and
Python values; not CUDA tensors). The whole run has one time limit. A
rank's exception, or a rank that exits with a nonzero code, is raised
in the parent with its traceback, and the other ranks are killed: none
outlives the call. ``fn`` must be importable by name (a module-level
function), since the ranks start from a fresh interpreter.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _mesh_device(device_type: Any) -> str:
    kind = resolve_device(device_type).type
    return "cpu" if kind == "meta" else kind


def fake_world(n: int, rank: int = 0) -> None:
    """Join a world of ``n`` ranks on the ``fake`` backend as ``rank``:
    one process, no peers; every collective returns at once and leaves
    its output as it was (values are not computed, shapes and counts
    are)."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Any = None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or with ``multi_pod`` (2, 16, 16)
    ``("pod", "data", "model")``, over the first 256 or 512 ranks of the
    initialized world, on ``cuda`` unless ``"cpu"`` or ``"meta"`` is
    asked for."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have} — start a world "
            f"of {n} ranks first (fake_world({n}) for a dry run)")
    return DeviceMesh(_mesh_device(device_type),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"),
                   device_type: Any = None) -> DeviceMesh:
    """A mesh over every rank of the initialized process group, on
    ``cuda`` unless ``"cpu"`` is asked for (with no GPU and no explicit
    request this raises)."""
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs an initialized process "
                         f"group of {n} ranks")
    return init_device_mesh(_mesh_device(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def _rank_main(fn: Callable[..., Any], rank: int, world: int, rdv: str,
               backend: str, timeout: float, args: tuple, out: Any) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{rdv}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:                          # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    out.put((rank, True, result))


def spawn(fn: Callable[..., Any], world: int, *args: Any,
          timeout: float = 300.0, backend: str = "gloo") -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks; their results in
    rank order. Raises the first failure, or ``TimeoutError`` when the
    run outlasts ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="repro-torch-rdv-") as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, os.path.join(tmp, "rdv"),
                                   backend, timeout, args, out),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world}-rank run outlasted {timeout} s; ranks "
                        f"{sorted(set(range(world)) - set(results))} did "
                        f"not finish")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} exited with "
                                           f"code {dead[0][1]}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                results[rank] = payload
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            out.close()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]}")
    return [results[r] for r in range(world)]
