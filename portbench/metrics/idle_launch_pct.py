"""Model step: the share of the traced span in which the device is idle
while a host thread is inside an executor job
(``repro_torch.lm.job.*``) and not inside its copy of the result to the
host (``repro_torch.lm.sync``): the host is still issuing the eager step
(``harness/spans.py``).  With ``idle_sync_pct`` and ``idle_sched_pct`` it
sums to ``device_idle_pct``."""
from portbench.harness import spans


def read(run):
    return spans.idle_pct(run, "launch")
