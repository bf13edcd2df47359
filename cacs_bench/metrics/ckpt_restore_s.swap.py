"""Mean wall seconds of the port tracer's ckpt/restore spans that began
in the window (program span)."""
import statistics


def read(run):
    xs = run.data["ckpt_restore_s"]
    return statistics.fmean(xs) if xs else None
