"""Seconds of the window's swap-in: the svc.apps.resume(cid) call (host
clock around it) and then the first train step after it, as the program's
TrainerApp.step_times timed it."""


def read(run):
    return run.data["resume_s"]
