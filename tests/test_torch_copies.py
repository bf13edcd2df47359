"""Drift guard for the modules the port copies from the JAX package.

The port imports nothing of ``repro``, so it keeps its own copies of the
jax-free modules it needs. These must stay the reference's: once
``repro_torch`` is read as ``repro``, each copy equals its reference
line for line, but for the deltas listed here by line. A change on
either side without the other fails its case.
"""
import difflib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"

# port copy -> the lines where it may differ from its reference: each
# delta as (reference lines, port lines), 1-based, after the rename
COPIES = {
    "ckpt/plane.py": [],
    "ckpt/gc.py": [],
    "ckpt/snapshot.py": [],
    # thread ids repeat across processes: the temporary name carries the
    # pid, so two ranks of a sharded save can put one key at once
    "ckpt/storage.py": [((223, 224), (223, 226)), ((240, 240), (242, 242))],
    "launch/inject_tables.py": [],
    "launch/report.py": [],
    "obs/__init__.py": [],
    "obs/telemetry.py": [],
    # the port's tracer places spans on the wall clock's epoch (an anchor
    # pair and wall_ns), keeps its newest records at the cap, and opens a
    # span with a plain context manager (a generator's costs a decode
    # step more)
    "obs/trace.py": [
        ((30, 29), (30, 34)), ((33, 32), (38, 38)), ((35, 34), (41, 41)),
        ((36, 36), (43, 43)), ((38, 38), (45, 45)), ((95, 94), (102, 157)),
        ((99, 100), (162, 164)), ((108, 108), (172, 172)),
        ((110, 109), (174, 174)), ((117, 117), (182, 181)),
        ((120, 120), (184, 186)), ((122, 141), (188, 189)),
        ((156, 156), (204, 204)), ((158, 158), (206, 205)),
        ((180, 179), (227, 237)), ((264, 263), (322, 329))],
    "sim/simtime.py": [],
}


def _deltas(ref_lines, port_lines):
    """(reference lines, port lines) of every difference, 1-based and
    inclusive (an empty side is its insertion point)."""
    sm = difflib.SequenceMatcher(a=ref_lines, b=port_lines, autojunk=False)
    return [((i1 + 1, i2), (j1 + 1, j2))
            for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal"]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_port_copy_equals_its_reference(rel):
    ref = (SRC / "repro" / rel).read_text().splitlines()
    port = (SRC / "repro_torch" / rel).read_text().replace(
        "repro_torch", "repro").splitlines()
    assert _deltas(ref, port) == COPIES[rel], rel
