"""Seconds of the window's ``app/stop`` span: the swap-out waiting for
the job to stop once its image is written (program span)."""
from cacs_bench import spans


def read(run):
    stop = spans.first_ending_in(run, "app/stop")
    return None if stop is None else (stop[2] - stop[1]) / 1e9
