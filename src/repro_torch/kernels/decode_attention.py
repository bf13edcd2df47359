"""decode_attention — one query token over a KV cache, GQA, on the card.

Port of ``repro/kernels/decode_attention.py``.
``decode_attention_bhd_cuda`` is the hand-written CUDA kernel
(``csrc/decode_attention.cu``, built by ``kernels.build``) that replaces
``_decode_kernel``; ``decode_attention_bhd_plain`` is its plain PyTorch
version (the f32 oracle ``ref.decode_attention_ref``). The dispatcher
``decode_attention_bhd`` takes the plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises; for a ``meta``
tensor it returns the output's shape and records the launch's FLOPs and
bytes (``decode_attention_bhd_meta``). ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through it.

``pos`` is a host integer handed to the kernel as an argument, or a 0-d
int32 tensor on the card that the kernel reads (a decode step captured
in a CUDA graph, whose grid cannot follow ``pos``): no step builds
anything anew. Slots past ``pos`` are never read. Like the TPU
kernel, this one has no sliding window. With ``return_lse`` every route
also returns each head's natural-log log-sum-exp of its scaled scores
(f32 ``[B, H]``), which the kernel writes beside the output, so the data
ranks of a context-parallel decode can merge their slices' results
(``sharding.specs.merge_attention``). ``pos = -1`` is an empty slice (a
rank whose slots all lie past the token): the output is 0 and ``lse``
-inf, returned on every route without a launch, since ``pos`` is known on
the host. How the slots are split over
blocks is ``decode_plan``'s, a function of the shapes and ``pos`` alone:
never of the card, so a job resumed on another card gives the same bits.
With ``pos`` on the card the kernel evaluates that split itself, on a grid
of the most chunks the shapes allow (``plan_split``), and gives the same
bits as with ``pos`` on the host; it takes no ``lse`` and no empty slice
(the context-parallel decode's ``pos`` stays on the host).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check_launch, on_device
from repro_torch.kernels.flash_attention import check_aligned, check_operands

LAUNCHES: Dict[str, int] = {"decode_attention": 0}

# The split of slots 0..pos: about PLAN_BLOCKS blocks a call, chunks of a
# multiple of CHUNK_STEP slots, at most MAX_CHUNKS chunks (the last block
# of a (b, kv-head) holds every chunk's m and l in shared memory; the same
# limit is kMaxChunks of csrc/decode_attention.cu).
PLAN_BLOCKS = 4096
CHUNK_STEP = 64
MAX_CHUNKS = 512


@dataclass(frozen=True)
class DecodePlan:
    chunk: int        # slots per chunk (the last may hold fewer)
    n_chunks: int     # ceil((pos + 1) / chunk)
    heads: int        # q-heads per block: 1, 2, 4 or 8
    head_groups: int  # ceil(g / heads)
    blocks: int       # n_chunks * B * Hkv * head_groups


def plan_split(B: int, Hkv: int, g: int) -> Tuple[int, int, int]:
    """The shapes' part of ``decode_plan``: (q-heads per block, head
    groups, ``want``: the most chunks any ``pos`` is split into)."""
    heads = 1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else 8
    head_groups = -(-g // heads)
    want = min(MAX_CHUNKS, max(1, PLAN_BLOCKS // (B * Hkv * head_groups)))
    return heads, head_groups, want


def decode_plan(B: int, Hkv: int, g: int, pos: int) -> DecodePlan:
    """How the kernel splits slots ``0..pos`` of a ``[B, Hkv]`` cache read
    by ``g`` q-heads per kv-head. Chunk ``c`` holds slots ``[c * chunk,
    min((c + 1) * chunk, pos + 1))``."""
    heads, head_groups, want = plan_split(B, Hkv, g)
    n = pos + 1
    chunk = -(-n // want)
    chunk = max(CHUNK_STEP, -(-chunk // CHUNK_STEP) * CHUNK_STEP)
    n_chunks = -(-n // chunk)
    return DecodePlan(chunk, n_chunks, heads, head_groups,
                      n_chunks * B * Hkv * head_groups)


# one ticket counter per (b, kv-head, head group), kept per device and
# stream: the kernel leaves them at 0, so they are allocated once
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(device: torch.device, stream: int,
                   n: int) -> torch.Tensor:
    """The tickets of a launch on ``stream``. A launch captured in a CUDA
    graph gets counters of its own, zeroed by the graph before the
    kernel: a replay runs on whatever stream it is given, beside eager
    launches and other graphs, so it shares no stream's counters."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                        device=device)
    return t


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p] + [i] * 9 \
            + [ctypes.c_float, p, p, p, p, p]
        lib.decode_attention_fwd.restype = i
        lib._typed = True
    return lib


Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _empty(q: torch.Tensor, return_lse: bool) -> Out:
    """An empty slice's result: zeros, and -inf for ``lse``."""
    out = torch.zeros_like(q)
    if not return_lse:
        return out
    return out, torch.full(q.shape[:2], -math.inf, dtype=torch.float32,
                           device=q.device)


def decode_attention_bhd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos,
                               return_lse: bool = False,
                               scale: Optional[float] = None) -> Out:
    """q: [B,H,hd]; k,v: [B,Hkv,T,hd]; slots 0..pos -> [B,H,hd], and with
    ``return_lse`` the f32 [B,H] log-sum-exp (``pos = -1``: zeros and
    -inf); scores scaled by ``scale`` (default 1/sqrt(hd))."""
    if return_lse:
        return ref.decode_attention_lse_ref(q, k, v, pos, scale)
    if int(pos) < 0:
        return _empty(q, False)
    return ref.decode_attention_ref(q, k, v, pos, scale)


def decode_attention_bhd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pos,
                              return_lse: bool = False,
                              scale: Optional[float] = None) -> Out:
    """The kernel: same contract as ``decode_attention_bhd_plain``; the
    output has q's layout, ``lse`` is a contiguous f32 [B,H] the kernel
    writes. q, k and v are loaded in 16-byte pieces
    (``check_aligned``). ``pos = -1`` launches nothing. A ``pos`` on the
    card (a 0-d int32 tensor on q's device, without ``lse``) is the
    caller's to keep in [0, T): the host never reads it. ``scale`` goes to
    the kernel as an f32 argument; by default (None) the kernel forms
    1/sqrt(hd) itself, as it always has."""
    check_operands("decode_attention", q, k, v)
    if scale is not None and not scale > 0:
        raise ValueError(f"decode_attention: scale {scale} <= 0")
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be [B,H,hd], got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    pos_dev = pos if isinstance(pos, torch.Tensor) else None
    if pos_dev is not None:
        if (return_lse or pos_dev.shape != () or pos_dev.dtype != torch.int32
                or pos_dev.device != q.device):
            raise ValueError("decode_attention: a pos on the card is a 0-d "
                             "int32 tensor on q's device, without lse")
        heads, head_groups, n_chunks = plan_split(B, Hkv, H // Hkv)
        pos = chunk = 0                  # the kernel's own, from pos_dev
    else:
        pos = int(pos)
        if not -1 <= pos < T:
            raise ValueError(f"decode_attention: pos {pos} outside the "
                             f"cache [-1, {T})")
        if pos < 0:
            return _empty(q, return_lse)
        plan = decode_plan(B, Hkv, H // Hkv, pos)
        heads, head_groups, n_chunks, chunk = (plan.heads, plan.head_groups,
                                               plan.n_chunks, plan.chunk)
    if q.numel() == 0:
        return _empty(q, return_lse)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    check_aligned("decode_attention", q, k, v)
    lib = _lib()
    stream = build.current_stream(q.get_device())
    part = tickets = None
    if n_chunks > 1:
        part = torch.empty(n_chunks * B * Hkv * head_groups * heads
                           * (hd + 2), dtype=torch.float32, device=q.device)
        tickets = _ticket_buffer(q.device, stream, B * Hkv * head_groups)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2])
    with on_device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, int(q.dtype == torch.bfloat16), B, H, Hkv, hd, pos,
            chunk, n_chunks, heads, 0.0 if scale is None else float(scale),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if pos_dev is None else pos_dev.data_ptr(), stream)
    check_launch(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return (out, lse) if return_lse else out


def decode_attention_bhd_meta(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pos,
                              return_lse: bool = False,
                              scale: Optional[float] = None) -> Out:
    """The kernel's route on ``meta`` tensors: the output's shape alone,
    and the launch's FLOPs (4 a slot 0..pos a head and head-dim element)
    and HBM bytes (q, slots 0..pos of k and v, the output, and the f32
    ``lse`` where it is asked for) recorded in ``build.META_CALLS``. An
    empty slice (``pos = -1``) records nothing: it launches nothing."""
    B, H, hd = q.shape
    n = int(pos) + 1
    if n > 0:
        build.record_meta("decode_attention", 4 * B * H * hd * n,
                          q.element_size() * (2 * q.numel()
                                              + 2 * B * k.shape[1] * n * hd)
                          + (4 * B * H if return_lse else 0))
    out = torch.empty_like(q)
    if not return_lse:
        return out
    return out, torch.empty((B, H), dtype=torch.float32, device="meta")


def decode_attention_bhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos, return_lse: bool = False,
                         scale: Optional[float] = None) -> Out:
    """q: [B,H,hd]; k,v: [B,Hkv,T,hd]; slots 0..pos -> [B,H,hd], and with
    ``return_lse`` (out, lse f32 [B,H]); scores scaled by ``scale``
    (default 1/sqrt(hd))."""
    if q.device.type == "meta":
        return decode_attention_bhd_meta(q, k, v, pos, return_lse, scale)
    if q.device.type == "cpu":
        return decode_attention_bhd_plain(q, k, v, pos, return_lse, scale)
    return decode_attention_bhd_cuda(q, k, v, pos, return_lse, scale)
