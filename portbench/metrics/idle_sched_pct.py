"""Session scheduler: the share of the traced span in which the device is
idle and no executor job (``repro_torch.lm.job.*``) is open: the
scheduler's decisions, the host argmax of ``_collect``, emission,
admission bookkeeping and the clients' polling (``harness/spans.py``)."""
from portbench.harness import spans


def read(run):
    return spans.idle_pct(run, "sched")
