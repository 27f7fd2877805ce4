"""Session admission: the 90th percentile (nearest rank), over every
request submitted in the window, of first token less submission (infinite
for a request whose first token never came).  Per-layer, not end to end:
its runs spread too widely for it to stand under a bound (the host paces
the cells)."""
from portbench.harness import window as W


def read(run):
    return W.percentile(W.ttft_ms(run.requests, run.w0, run.w1), 90)
