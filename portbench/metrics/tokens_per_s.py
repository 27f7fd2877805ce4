"""End to end: tokens emitted in the window, first tokens included, over
its seconds."""
from portbench.harness import window as W


def read(run):
    return W.tokens_per_s(run.requests, run.w0, run.w1)
