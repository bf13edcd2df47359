"""Seconds of the window's swap-out, from svc.apps.suspend(cid) until the
job is SUSPENDED (host clock around the call)."""


def read(run):
    return run.data["suspend_s"]
