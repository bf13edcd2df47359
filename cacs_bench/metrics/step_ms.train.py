"""Median of TrainerApp.step_times over the steps the window kept (those
after the resume), in ms: wall time around each step, which ends in a
stream synchronize (program counter)."""
import statistics


def read(run):
    xs = run.data["step_times"]
    return statistics.median(xs) * 1e3 if xs else None
