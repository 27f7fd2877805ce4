"""Model step: the share of the traced span in which the device is idle,
no host thread is issuing a job's step, and some thread is inside a job's
copy of its result to the host (``repro_torch.lm.sync``: the pageable copy
of the logits and their conversion to numpy; ``harness/spans.py``)."""
from portbench.harness import spans


def read(run):
    return spans.idle_pct(run, "sync")
