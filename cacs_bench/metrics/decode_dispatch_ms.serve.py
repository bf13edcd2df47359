"""Median duration of the port's ``serve/dispatch`` spans (the model's
decode step enqueued by ``Engine.decode``) that end in the window, in ms
(program span)."""
from cacs_bench import spans


def read(run):
    return spans.median_ms(spans.ending_in(run, "serve/dispatch"))
