"""Coding: the share of the traced span that the scheduler spends
re-prefilling parity slot columns (``repro_torch.lm.admit.rebuild``, one
column at a time, from its jobs' submission to the last result), during
which no stream decodes.  None where the span holds no rebuild."""
from portbench.harness import spans


def read(run):
    return spans.span_pct(run, "repro_torch.lm.admit.rebuild")
