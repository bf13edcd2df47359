"""The decode kernel's split of cache slots 0..pos over blocks
(``repro_torch.kernels.decode_attention.decode_plan``), on the CPU.

The split decides the kernel's order of summation, so it must be a
function of the shapes and ``pos`` alone, never of the card: a served job
suspended on one card and resumed on another emits the same tokens.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from test_torch_cuda import DECODE_EDGE_CASES

SHAPES = [(8, 4, 3), (1, 1, 1), (2, 2, 2), (1, 2, 8), (2, 1, 16),
          (3, 2, 3), (64, 8, 1), (1, 1, 5)]          # (B, Hkv, g)
POSITIONS = [0, 1, 63, 64, 65, 639, 1000, 4095, 16383, 32767, 262143]


def _chunks(plan, pos):
    return [range(c * plan.chunk, min((c + 1) * plan.chunk, pos + 1))
            for c in range(plan.n_chunks)]


@pytest.mark.parametrize("shape", SHAPES)
def test_chunks_cover_the_slots_once_in_order(shape):
    for pos in POSITIONS:
        plan = DA.decode_plan(*shape, pos)
        chunks = _chunks(plan, pos)
        assert all(len(c) > 0 for c in chunks)
        assert list(itertools.chain(*chunks)) == list(range(pos + 1))
        assert plan.chunk % DA.CHUNK_STEP == 0
        assert plan.n_chunks <= DA.MAX_CHUNKS


@pytest.mark.parametrize("shape", SHAPES)
def test_heads_per_block_cover_the_group(shape):
    B, Hkv, g = shape
    plan = DA.decode_plan(B, Hkv, g, 999)
    assert plan.heads in (1, 2, 4, 8)
    assert plan.heads * plan.head_groups >= g
    assert plan.heads * (plan.head_groups - 1) < g   # no empty group
    assert plan.blocks == plan.n_chunks * B * Hkv * plan.head_groups


def test_plan_depends_on_the_shapes_and_pos_alone(monkeypatch):
    """Nothing of the card is read: with every query about a device made
    to fail, the plans are the ones computed before."""
    want = {(s, p): DA.decode_plan(*s, p) for s in SHAPES for p in POSITIONS}

    def no_card(*a, **k):
        raise AssertionError("decode_plan asked about the card")
    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    for (s, p), plan in want.items():
        assert DA.decode_plan(*s, p) == plan


def test_served_and_long_shapes_fill_the_card():
    """repro-100m serving (B = 8, 4 kv-heads, g = 3): the served step at
    pos 639 still gives >= 64 blocks; the long case (pos 32767) a few
    thousand blocks, each looping over more slots than one 64-slot tile."""
    served = DA.decode_plan(8, 4, 3, 639)
    assert served.blocks >= 64
    assert (served.chunk, served.n_chunks, served.blocks) == (64, 10, 320)
    long_ = DA.decode_plan(8, 4, 3, 32767)
    assert 2000 <= long_.blocks <= 8192
    assert long_.chunk > 64
    assert (long_.chunk, long_.n_chunks, long_.blocks) == (256, 128, 4096)


def test_card_edge_cases_reach_the_edges():
    """The decode cases of tests/test_torch_cuda.py hit what they are
    there for: pos 0, a chunk's last slot (size - 1) and a new chunk's
    first (size), pos T - 1, T far larger than a chunk, g > 8."""
    seen = set()
    for B, T, H, Hkv, hd, pos in DECODE_EDGE_CASES:
        plan = DA.decode_plan(B, Hkv, H // Hkv, pos)
        if pos == 0:
            seen.add("pos 0")
        if (pos + 1) % plan.chunk == 0:
            seen.add("size - 1")
        if (pos + 1) % plan.chunk == 1 and plan.n_chunks > 1:
            seen.add("size")
        if pos == T - 1 and T >= 16 * plan.chunk:
            seen.add("T - 1")
        if plan.chunk > DA.CHUNK_STEP and plan.n_chunks > 1:
            seen.add("long chunks")
        if plan.head_groups > 1:
            seen.add("g > 8")
    assert seen == {"pos 0", "size - 1", "size", "T - 1", "long chunks",
                    "g > 8"}
