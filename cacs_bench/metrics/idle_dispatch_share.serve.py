"""Share of the card's idle time in the window that lies inside the
port's ``serve/dispatch`` spans: the card waiting on the host to enqueue
the decode step, in % (device trace against program spans)."""
from cacs_bench import spans


def read(run):
    w = run.window
    if spans.window(run) is None or not w.events:
        return None
    dispatch = sorted((max(t0, w.t_open), t1) for _, t0, t1 in
                      spans.ending_in(run, "serve/dispatch"))
    gaps = spans.idle(run)
    total = sum(e - s for s, e in gaps)
    if not dispatch or not total:
        return None
    return 100.0 * spans.overlap(gaps, dispatch) / total
