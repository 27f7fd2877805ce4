"""Device: the share of the traced span in which no device operation
(kernel, copy or fill) ran: one less the union of their intervals."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100 * (1 - tr.busy_s / tr.window_s)
