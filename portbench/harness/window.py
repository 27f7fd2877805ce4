"""The window's arithmetic, from the futures' timestamps alone (monotonic
seconds): every end-to-end metric is taken over all the work of the
benchmark's own window [w0, w1).

* tokens per second: tokens emitted in the window, first tokens included,
  over its length;
* time to first token: for every request submitted in the window, its
  first token's time less its submission; one that never came is
  infinite;
* inter-token gaps: between consecutive tokens of one stream, both in the
  window (the gap before a stream's first token is not one of them);
* decode rounds: the distinct emit times in the window of tokens other
  than a stream's first (a round emits all its tokens at one time)."""
from __future__ import annotations

import math


def inside(t, w0, w1):
    return t is not None and w0 <= t < w1


def tokens(reqs, w0, w1):
    return sum(1 for r in reqs for t in r.times[1] if inside(t, w0, w1))


def tokens_per_s(reqs, w0, w1):
    return tokens(reqs, w0, w1) / (w1 - w0)


def ttft_ms(reqs, w0, w1):
    out = []
    for r in reqs:
        if inside(r.t_submit, w0, w1):
            emits = r.times[1]
            out.append(1e3 * (emits[0] - r.t_submit) if emits else math.inf)
    return out


def admission_ms(reqs, w0, w1):
    """First token less admission, for requests admitted in the window."""
    out = []
    for r in reqs:
        t_admit, emits = r.times
        if inside(t_admit, w0, w1) and emits:
            out.append(1e3 * (emits[0] - t_admit))
    return out


def gaps_ms(reqs, w0, w1):
    out = []
    for r in reqs:
        e = r.times[1]
        out.extend(1e3 * (b - a) for a, b in zip(e, e[1:])
                   if inside(a, w0, w1) and inside(b, w0, w1))
    return out


def rounds(reqs, w0, w1):
    return len({t for r in reqs for t in r.times[1][1:]
                if inside(t, w0, w1)})


def percentile(values, q):
    """The nearest-rank q-th percentile (an infinite value counts as the
    largest); None for no values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def events(reqs, w0, w1):
    """(admissions, finishes) in the window: first-token emissions, and
    streams whose last token fell in it with all their tokens served."""
    adm = sum(1 for r in reqs if inside(r.times[0], w0, w1))
    fin = sum(1 for r in reqs if r.future is not None and r.future.done()
              and r.times[1] and inside(r.times[1][-1], w0, w1))
    return adm, fin


def round_ms(reqs, w0, w1):
    """The window's length over its decode rounds (None for none)."""
    n = rounds(reqs, w0, w1)
    return 1e3 * (w1 - w0) / n if n else None


def mean_admission_ms(reqs, w0, w1):
    v = admission_ms(reqs, w0, w1)
    return sum(v) / len(v) if v else None
