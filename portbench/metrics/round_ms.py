"""Session scheduler: the window's length over the decode rounds completed
in it (rounds counted from the futures' shared emit times, on the host's
clock)."""
from portbench.harness import window as W


def read(run):
    return W.round_ms(run.requests, run.w0, run.w1)
