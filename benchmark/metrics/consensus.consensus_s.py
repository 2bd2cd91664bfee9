"""consensus.consensus_s: seconds a job in the harness's consensus span
(``stages.combine_arrays``, the TPM's upload and ``stages.consensus_arrays``
at the cell's K), synchronized, the mean over the window's jobs."""



def read(run):
    return run.span_seconds("consensus")
