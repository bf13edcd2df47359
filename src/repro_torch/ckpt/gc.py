"""Checkpoint retention / garbage collection.

With content-addressed chunks (layout format v2) a chunk may be shared by
any number of committed steps, so deleting a step can no longer delete its
chunks by prefix. ``collect`` is therefore mark-and-sweep:

  1. drop the *step directories* (manifest + COMMITTED + any legacy v1
     chunks, which are step-private) of expired steps;
  2. mark: union the chunk refcounts of every surviving committed manifest;
  3. sweep: delete CAS chunks whose refcount is zero
     (storage.delete_unreferenced — the refcount-aware delete).

Sweep runs only after the step deletions commit, so a crash mid-collect can
strand orphan chunks but never break a live checkpoint; a later collect or
``sweep_orphans`` reclaims them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.ckpt.layout import cas_prefix, step_prefix
from repro_torch.ckpt.reader import list_steps, load_manifest
from repro_torch.ckpt.storage import ObjectStore


def live_chunk_refs(store: ObjectStore, prefix: str,
                    steps: Optional[List[int]] = None) -> Dict[str, int]:
    """chunk store key -> number of committed manifests referencing it."""
    refs: Dict[str, int] = {}
    for s in (list_steps(store, prefix) if steps is None else steps):
        for key, n in load_manifest(store, prefix, s).chunk_refs().items():
            refs[key] = refs.get(key, 0) + n
    return refs


def sweep_orphans(store: ObjectStore, prefix: str) -> List[str]:
    """Delete CAS chunks referenced by no committed manifest.

    Returns the deleted keys so callers (checkpoint_manager) can invalidate
    any writer-side dedup caches.
    """
    refs = live_chunk_refs(store, prefix)
    deleted = []
    for key in store.list(cas_prefix(prefix)):
        if store.delete_unreferenced(key, refs.get(key, 0)):
            deleted.append(key)
    return deleted


def collect(store: ObjectStore, prefix: str, *, keep_last: int = 3,
            keep_every: int = 0, on_swept=None) -> List[int]:
    """Delete old committed checkpoints (mark-and-sweep).

    keep_last:  always retain the newest k steps.
    keep_every: additionally retain steps divisible by this (milestones).
    on_swept:   optional callback receiving the swept CAS keys — writers
                holding dedup caches use it to invalidate entries whose
                chunks just disappeared.
    Returns the deleted step numbers.
    """
    steps = list_steps(store, prefix)
    keep = set(steps[-keep_last:]) if keep_last else set()
    if keep_every:
        keep |= {s for s in steps if s % keep_every == 0}
    deleted = []
    for s in steps:
        if s in keep:
            continue
        store.delete_prefix(step_prefix(prefix, s))
        deleted.append(s)
    if deleted:
        swept = sweep_orphans(store, prefix)
        if on_swept is not None and swept:
            on_swept(swept)
    return deleted
