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
