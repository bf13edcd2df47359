"""Model FLOPs of the window's decode steps (2 x the parameters a token
activates, plus attention over the cache) over the window's seconds, as
a share of the card's bf16 peak, in %."""
from cacs_bench import flops


def read(run):
    d = run.data
    return (100.0 * sum(d["decode_flops"]) / d["window_s"]
            / flops.bf16_peak())
