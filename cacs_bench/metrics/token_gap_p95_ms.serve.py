"""95th percentile of the gaps between the ends of successive
``serve/step`` spans in the window, the program's own timestamp of each
token, in ms (program span)."""
import numpy as np

from cacs_bench import spans


def read(run):
    ends = sorted(t1 for _, _, t1 in spans.ending_in(run, "serve/step"))
    if len(ends) < 2:
        return None
    return float(np.percentile(np.diff(ends), 95)) / 1e6
