"""95th percentile of the gaps between successive decode steps, over
every step in the window, in ms (host clock)."""
import numpy as np


def read(run):
    gaps = run.data["step_gaps"]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
