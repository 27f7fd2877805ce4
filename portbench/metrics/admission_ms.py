"""Session admission: the mean, over requests admitted in the window, of
first token less admission (both the future's timestamps, on the host's
clock)."""
from portbench.harness import window as W


def read(run):
    return W.mean_admission_ms(run.requests, run.w0, run.w1)
