"""Seconds from the process's start until the window opens: imports, the
kernels built or found built, the weights drawn, the job submitted and
warmed up (host clock)."""


def read(run):
    return run.data["setup_s"]
