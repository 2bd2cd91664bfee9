"""consensus.kselect_s: seconds a job in the harness's k-selection span
(``stages.k_stats_arrays`` over the cell's K list, fed by the device
twins), synchronized, the mean over the window's jobs."""



def read(run):
    return run.span_seconds("kselect")
