"""Model FLOPs of the train steps kept in the window (6 N + 12 L H hd S a
token, no recompute) over the window's seconds, as a share of the card's
bf16 peak, in %."""
from cacs_bench import flops


def read(run):
    d = run.data
    done = d["progress_steps"] * d["tokens_per_step"]
    return (100.0 * done * d["train_flops_per_token"] / d["window_s"]
            / flops.bf16_peak())
