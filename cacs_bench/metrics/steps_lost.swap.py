"""The ``work_lost`` of the window's ``app/stop`` span: the steps the job
trained after the swap-out's pin, which the resume discards (program
span)."""
from cacs_bench import spans


def read(run):
    stop = spans.first_ending_in(run, "app/stop")
    return None if stop is None else stop[0].args.get("work_lost")
