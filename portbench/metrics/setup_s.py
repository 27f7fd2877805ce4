"""End to end: process start to the window's open (imports, weights,
the session's pools and warm-up, the kernel library, the traffic's
warm-up)."""


def read(run):
    return run.setup_s
