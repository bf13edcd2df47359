"""Tokens generated inside the window, over every row of the batch, over
the window's seconds (host clock)."""


def read(run):
    d = run.data
    return len(d["step_gaps"]) * d["batch"] / d["window_s"]
