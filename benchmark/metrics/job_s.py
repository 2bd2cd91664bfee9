"""job_s: the window's length over the whole jobs in it, seconds: the time
to a cNMF solution (prepare, factorize, combine, consensus, k-selection),
one job after another."""


def read(run):
    return run.window_s / len(run.jobs) if run.jobs else None
