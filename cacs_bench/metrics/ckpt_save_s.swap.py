"""Mean wall seconds of the port tracer's ckpt/save spans that began in
the window (program span)."""
import statistics


def read(run):
    xs = run.data["ckpt_save_s"]
    return statistics.fmean(xs) if xs else None
