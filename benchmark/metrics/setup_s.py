"""setup_s: seconds from the process's start to the window's: imports,
CUDA, the program's kernel library (built on a checkout's first run), the
counts drawn from the seed and one short warm-up job."""


def read(run):
    return run.setup_s
