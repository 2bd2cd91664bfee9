"""peak_device_gib: the most device memory the program held in the window
(``torch.cuda.max_memory_allocated`` after a reset at the end of set-up),
GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
