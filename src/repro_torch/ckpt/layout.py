"""Topology-agnostic checkpoint layout: pytree <-> named chunks + manifest.

The manifest records, per leaf: global shape, dtype, and a list of chunks
addressed by *global offsets* — never mesh coordinates. Any process on any
mesh can therefore restore any leaf under any sharding by reading the
overlapping chunks (reader.py). This is the paper's "compile for the common
denominator" portability rule applied to device topologies (DESIGN.md §2).

Two chunk layouts coexist (see docs/architecture.md):
  * format v1 (legacy): chunks live under their step directory
    (``<prefix>/step_<n>/chunks/<leaf>::o<off>``) and are private to one step.
  * format v2 (content-addressed): chunks live in a shared namespace keyed by
    the blake2b digest of their *encoded* bytes
    (``<prefix>/cas/<digest>``) and may be shared by any number of steps —
    the substrate for incremental checkpointing (writer.py skips the put for
    any chunk whose digest is already stored).
``Manifest.from_json`` loads both; v1 manifests simply carry ``hash=None``
chunks.

Port of ``repro/ckpt/layout.py``. The pytree walk replaces
``jax.tree_util.tree_flatten_with_path`` and reproduces it exactly
(``repro_torch.tree``: dicts in sorted-key order, lists and tuples by
index, ``None`` an empty subtree, anything else a leaf).
``structure_skeleton`` keeps insertion order, as the reference does, so
leaf names, leaf order and MANIFEST bytes match the JAX package's for the
same tree. bf16 has no numpy dtype without
``ml_dtypes``: on the host its bytes ride in int16 arrays (``np_dtype``),
and leaves name it ``"bfloat16"`` in the manifest, as the reference does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.ckpt.compression import is_bf16
from repro_torch.sharding.specs import region_of
from repro_torch.tree import leaves_with_path

MANIFEST = "MANIFEST.json"
COMMITTED = "COMMITTED"
CAS_DIR = "cas"
FORMAT_VERSION = 2                    # content-addressed chunks


def np_dtype(name: str) -> np.dtype:
    """Host carrier dtype of a manifest dtype name (bf16 -> int16 words)."""
    return np.dtype(np.int16) if is_bf16(name) else np.dtype(name)


def dtype_name(dt: Any) -> str:
    """Manifest dtype name of a torch or numpy dtype ("float32", ...)."""
    return str(dt).removeprefix("torch.")


def host_array(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a host ndarray; bf16 as its int16 words."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def to_tensor(a: np.ndarray, dtype: str, device: Any) -> torch.Tensor:
    """Inverse of ``host_array``: a host array of manifest dtype ``dtype``
    (bf16 as int16 words) -> tensor on ``device``."""
    ok = a.flags.c_contiguous and a.flags.writeable
    t = torch.from_numpy(a if ok else a.copy())
    if is_bf16(dtype):
        t = t.view(torch.bfloat16)
    return t.to(device)


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

def leaf_items(tree: Any) -> List[Tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in leaves_with_path(tree)]


def structure_skeleton(tree: Any) -> Any:
    """JSON-serializable skeleton for target-free restores."""
    if isinstance(tree, dict):
        return {"!kind": "dict",
                "items": {k: structure_skeleton(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"!kind": "tuple" if isinstance(tree, tuple) else "list",
                "items": [structure_skeleton(v) for v in tree]}
    return {"!kind": "leaf"}


def build_from_skeleton(skel: Any, leaves: Dict[str, Any], path: str = "") -> Any:
    kind = skel["!kind"]
    if kind == "dict":
        return {k: build_from_skeleton(v, leaves, f"{path}{k}/")
                for k, v in skel["items"].items()}
    if kind in ("tuple", "list"):
        seq = [build_from_skeleton(v, leaves, f"{path}{i}/")
               for i, v in enumerate(skel["items"])]
        return tuple(seq) if kind == "tuple" else seq
    return leaves[path[:-1]]


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkInfo:
    offset: Tuple[int, ...]
    shape: Tuple[int, ...]
    key: str                          # store key of the chunk object
    nbytes: int                       # encoded size
    hash: Optional[str] = None        # blake2b digest of encoded bytes (v2)


@dataclasses.dataclass
class PreEncodedLeaf:
    """Staging-form leaf whose shards were already encoded on device.

    Appears as an (unregistered, hence atomic) pytree leaf inside a
    snapshot produced by ``TrainerApp.snapshot_async`` with a lossy swap
    codec: ``chunks`` carries ``(offset, shape, PreEncodedChunk)`` triples
    in place of host ndarrays. ``writer._stage`` passes these straight to
    the upload pipeline; the manifest entry (shape/dtype/kind) is
    indistinguishable from a host-encoded leaf, so restore needs no new
    code path.
    """
    shape: Tuple[int, ...]
    dtype: str
    chunks: List[Tuple[Tuple[int, ...], Tuple[int, ...], Any]]
    kind: str = "array"


@dataclasses.dataclass
class LeafInfo:
    name: str
    shape: Tuple[int, ...]
    dtype: str
    kind: str                         # "array" | "scalar"
    chunks: List[ChunkInfo]


@dataclasses.dataclass
class Manifest:
    step: int
    codec: str
    leaves: Dict[str, LeafInfo]
    skeleton: Any
    metadata: Dict[str, Any]
    version: int = FORMAT_VERSION

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            raise TypeError(o)
        return json.dumps(dataclasses.asdict(self), default=enc)

    def chunk_refs(self) -> Dict[str, int]:
        """store key -> number of references from this manifest."""
        refs: Dict[str, int] = {}
        for li in self.leaves.values():
            for c in li.chunks:
                refs[c.key] = refs.get(c.key, 0) + 1
        return refs

    @staticmethod
    def from_json(s: str) -> "Manifest":
        d = json.loads(s)
        leaves = {
            name: LeafInfo(
                name=li["name"], shape=tuple(li["shape"]), dtype=li["dtype"],
                kind=li["kind"],
                chunks=[ChunkInfo(tuple(c["offset"]), tuple(c["shape"]),
                                  c["key"], c["nbytes"], c.get("hash"))
                        for c in li["chunks"]])
            for name, li in d["leaves"].items()
        }
        return Manifest(step=d["step"], codec=d["codec"], leaves=leaves,
                        skeleton=d["skeleton"], metadata=d["metadata"],
                        version=d.get("version", 1))


def step_prefix(prefix: str, step: int) -> str:
    return f"{prefix}/step_{step:010d}"


def chunk_key(prefix: str, step: int, leaf: str,
              offset: Sequence[int]) -> str:
    """Format-v1 (step-private) chunk key; kept for full / legacy saves."""
    off = "o" + "_".join(str(int(o)) for o in offset) if offset else "o0"
    return f"{step_prefix(prefix, step)}/chunks/{leaf}::{off}"


def chunk_digest(data: bytes) -> str:
    """Content address of an encoded chunk (hex blake2b-160)."""
    return hashlib.blake2b(data, digest_size=20).hexdigest()


def cas_prefix(prefix: str) -> str:
    return f"{prefix}/{CAS_DIR}/"


def cas_key(prefix: str, digest: str) -> str:
    """Format-v2 content-addressed chunk key (shared across steps)."""
    return f"{cas_prefix(prefix)}{digest}"


# ---------------------------------------------------------------------------
# Shard enumeration
# ---------------------------------------------------------------------------

def local_shards(arr) -> List[Tuple[Tuple[int, ...], Tuple[int, ...],
                                    np.ndarray]]:
    """This process's unique shards of a leaf, copied to the host.

    A DTensor gives its local shard at its global offset, but only from
    the rank at coordinate 0 on every mesh dim that does not shard it
    (the replicas on the other ranks give nothing), so across the ranks
    each shard is written once, as the reference dedups a jax.Array's
    replicas. Any other leaf is one full shard.

    Returns [(offset, shape, host_ndarray)].
    """
    if isinstance(arr, DTensor):
        mesh = arr.device_mesh
        coord = mesh.get_coordinate()
        if any(c and not isinstance(p, Shard)
               for c, p in zip(coord, arr.placements)):
            return []
        off, shp = region_of(arr.shape, mesh, arr.placements)
        return [(off, shp, host_array(arr.to_local()))]
    a = host_array(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return [((0,) * a.ndim, a.shape, a)]
