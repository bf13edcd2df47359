"""Expert rows the MoE layers computed over the (token, choice) pairs they
routed, over the window's decode steps: the registry counters
``moe.expert_rows`` and ``moe.routed_pairs`` read as the window opens and
after it closes (program counter). 1 for a dropless dispatch; a capacity
dispatch computes every expert's slots a row. Nothing is read from a
program without the counters."""


def read(run):
    pairs, rows = run.data.get("moe_pairs"), run.data.get("moe_rows")
    if not pairs or rows is None:
        return None
    return rows / pairs
