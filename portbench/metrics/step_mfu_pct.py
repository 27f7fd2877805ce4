"""Model step: the operations the served tokens need, over the window's
seconds at the chip's peak (``harness/work.py``).  Each prompt whose first
token came in the window counts every layer for each prompt token, the
output head once and causal attention (4 hd per (query, key) pair and
head); each later token in the window counts every layer, the head and
attention over its keys.  Times (k + r) / k for the parity query of every
k.  Nothing is counted for parity-column re-prefills, MoE capacity padding
or experts read but not routed to."""
from portbench.harness import window as W, work


def read(run):
    cfg, t = run.cfg, run.traffic
    flops = 0.0
    for r in run.requests:
        P = len(r.prompt)
        for j, at in enumerate(r.times[1]):
            if not W.inside(at, run.w0, run.w1):
                continue
            flops += work.prefill_flops(cfg, P) if j == 0 else \
                work.decode_flops(cfg, P + j)
    if not flops:
        return None
    flops *= (t["k"] + t["r"]) / t["k"]
    return 100 * flops / ((run.w1 - run.w0) * work.PEAK_FLOPS[cfg["dtype"]])
