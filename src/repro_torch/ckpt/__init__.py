"""Checkpoint images (port of ``repro/ckpt``): MANIFEST v2, ``QS01`` int8
framing and blake2b CAS keys, shared with the reference package.

``restore`` and ``gang.load_gang_ranks`` place array leaves on the
``device`` they are given: ``cuda`` unless ``"cpu"`` is asked for; with
no GPU and no explicit request they raise. ``core.CACSService`` restores
through them onto its application's device (``app.device``).
"""
from repro_torch.ckpt.plane import DataPlaneConfig, PreEncodedChunk
from repro_torch.ckpt.layout import PreEncodedLeaf
from repro_torch.ckpt.reader import latest_step, list_steps, load_manifest, restore
from repro_torch.ckpt.snapshot import (DeferredSnapshot, ReadySnapshot,
                                 SnapshotHandle, resolve_state)
from repro_torch.ckpt.storage import (ChaosStorageError, FaultyStore, InMemoryStore,
                                LocalFSStore, ObjectStore, TwoTierStore)
from repro_torch.ckpt.writer import AsyncCheckpointer, save_checkpoint
from repro_torch.ckpt import gc

__all__ = [
    "latest_step", "list_steps", "load_manifest", "restore",
    "ChaosStorageError", "FaultyStore",
    "InMemoryStore", "LocalFSStore", "ObjectStore", "TwoTierStore",
    "AsyncCheckpointer", "save_checkpoint", "gc", "DataPlaneConfig",
    "PreEncodedChunk", "PreEncodedLeaf",
    "SnapshotHandle", "ReadySnapshot", "DeferredSnapshot", "resolve_state",
]
