"""Median gap between successive decode steps in the window, in ms (host
clock, the timestamps of itl_p95_ms)."""
import statistics


def read(run):
    gaps = run.data["step_gaps"]
    return statistics.median(gaps) * 1e3 if gaps else None
