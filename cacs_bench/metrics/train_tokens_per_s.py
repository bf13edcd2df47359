"""Tokens of the train steps the job kept, completed inside the window,
over the window's seconds; swaps inside the window count as time, and
steps that a swap-out throws away do not count (host clock)."""


def read(run):
    d = run.data
    return d["progress_steps"] * d["tokens_per_step"] / d["window_s"]
