"""End to end: the 95th percentile of the gaps between consecutive tokens
of one stream, both in the window."""
from portbench.harness import window as W


def read(run):
    return W.percentile(W.gaps_ms(run.requests, run.w0, run.w1), 95)
