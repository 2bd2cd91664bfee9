"""stages.prepare_s: seconds a job in the harness's prepare span
(``stages.prepare_arrays`` and the replicate seeds), synchronized, the
mean over the window's jobs."""



def read(run):
    return run.span_seconds("prepare")
