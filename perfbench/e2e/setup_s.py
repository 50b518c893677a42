"""Seconds from the process's start to the window's opening: imports, the
kernels' libraries, the weights, the warm-up and the first requests'
admission."""


def read(run):
    return run.setup_s
