"""Median duration of the port's ``serve/token_wait`` spans (the decode
loop blocked on the card for the step's tokens) that end in the window,
in ms (program span)."""
from cacs_bench import spans


def read(run):
    return spans.median_ms(spans.ending_in(run, "serve/token_wait"))
