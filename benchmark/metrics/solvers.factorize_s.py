"""solvers.factorize_s: seconds a job in the harness's factorize span (the
upload of the normalized counts and ``stages.factorize_grid``: every K's
restarts, the packed drain), synchronized, the mean over the window's
jobs."""



def read(run):
    return run.span_seconds("factorize")
