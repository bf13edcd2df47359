"""Share of the window in which no operation ran on the card: one minus
the union of the profiler's device intervals over the window, in %."""


def read(run):
    w = run.window
    if w is None or w.t_close is None or not w.events:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
