"""setup_s: from the process's start to the window's: imports, CUDA
start-up, the scene made and written, and the warm conversion (with the
kernels' build in a checkout's first run)."""


def read(run):
    return run.setup_s
