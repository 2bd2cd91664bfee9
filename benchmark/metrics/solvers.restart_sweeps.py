"""solvers.restart_sweeps: the sum of every restart's n_iter in a job (the
sweeps or iterations the solver needed to stop), as factorize returns
them, the mean over the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(sum(int(n.sum()) for n in job.n_iter.values())
               for job in run.jobs) / len(run.jobs)
