"""Median device time of the ``train/optimizer`` phase over the train steps
the window kept (``train/step`` spans that begin after the window's
``app/resume`` ends and end by the close): the ``device_ms`` the
port's ``PhaseTimer`` reads from a pair of CUDA events, in ms (program
counter)."""
from cacs_bench import spans


def read(run):
    return spans.phase_device_ms(run, "train/optimizer")
