"""Coding: the share of device time in operations launched from the
parity instance's executor thread (``lm-parity-0``): its decode of the
encoded embeddings and its parity-column re-prefills.  A device operation
is tied to its thread through its runtime launch event."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    tids = tr.thread_of("lm-parity-0")
    if not tids:
        return None
    return 100 * tr.device_s(lambda o: o.tid in tids) / tr.device_s()
