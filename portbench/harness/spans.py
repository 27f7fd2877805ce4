"""The program's own spans in a traced span's ``TraceData``.

``repro_torch`` marks its layers with ``repro_torch.*`` user annotations
(``repro_torch/trace.py``), which ``trace.reduce_events`` keeps among each
thread's CPU events (``TraceData.cpu``).  Here they become sets of
intervals, clipped to the traced span ``[t_on, t_off]``, and the device's
idle time (the span outside the union of device operations) is split by
what the host threads were doing:

* ``launch``: some thread is inside a ``repro_torch.lm.job.*`` span and not
  inside an ``repro_torch.lm.sync`` span (it is still issuing its step);
* ``sync``: otherwise, some thread is inside ``repro_torch.lm.sync``
  (copying a result to the host);
* ``sched``: no job span is open (the scheduler's own work between jobs).

The three parts cover the idle time once each, so their shares sum to
``device_idle_pct``.  A span open when the profiler starts is not recorded.
An executor thread runs nothing but jobs, so where its CPU events begin
before its first recorded job, those events belong to a job open at the
start: it counts as launching up to the last of them."""
from __future__ import annotations

JOB = "repro_torch.lm.job."
SYNC = "repro_torch.lm.sync"


def merge(ivs):
    """The union of intervals [(start, end)], sorted and disjoint."""
    out = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def length(ivs):
    return sum(b - a for a, b in ivs)


def intersect(xs, ys):
    """The intersection of two unions of disjoint sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys):
    """``xs`` without ``ys`` (both disjoint and sorted)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            c, d = ys[k]
            if c > a:
                out.append((a, c))
            a = max(a, d)
            k += 1
        if a < b:
            out.append((a, b))
    return out


def clip(tr, ivs):
    return merge((max(a, tr.t_on), min(b, tr.t_off)) for a, b in ivs)


def named(tr, pick):
    """{thread: [(start, end)]} of the program's spans whose name satisfies
    ``pick``, clipped to the traced span; threads with none left out."""
    out = {}
    for tid, evs in tr.cpu.items():
        ivs = clip(tr, [(s, e) for s, e, n in evs if pick(n)])
        if ivs:
            out[tid] = ivs
    return out


def has(tr, pick):
    return any(pick(n) for evs in tr.cpu.values() for _, _, n in evs)


def idle(tr):
    """The traced span outside the union of device operations."""
    return subtract([(tr.t_on, tr.t_off)],
                    [tuple(b) for b in tr.busy_intervals()])


def jobs(tr):
    """{thread: [(start, end)]} of executor jobs, with a job open at the
    profiler's start taken from the thread's CPU events before its first
    recorded job."""
    out = {}
    for tid, evs in tr.cpu.items():
        ivs = [(s, e) for s, e, n in evs if n.startswith(JOB)]
        if not ivs:
            continue
        first = min(s for s, _ in ivs)
        before = [(s, e) for s, e, _ in evs if s < first]
        if before:
            ivs.append((min(s for s, _ in before),
                        max(e for _, e in before)))
        out[tid] = clip(tr, ivs)
    return out


def idle_split(tr):
    """Seconds of device idle time {launch, sync, sched}, or None where the
    trace holds no job span (a program without the spans)."""
    if tr is None or not has(tr, lambda n: n.startswith(JOB)):
        return None
    syncs = named(tr, lambda n: n == SYNC)
    launching, syncing = [], []
    for tid, ivs in jobs(tr).items():
        launching += subtract(ivs, syncs.get(tid, []))
    for ivs in syncs.values():
        syncing += ivs
    launching, syncing = merge(launching), merge(syncing)
    gaps = idle(tr)
    launch = intersect(gaps, launching)
    sync = subtract(intersect(gaps, syncing), launching)
    total = length(gaps)
    return {"launch": length(launch) / 1e9, "sync": length(sync) / 1e9,
            "sched": (total - length(launch) - length(sync)) / 1e9}


def idle_pct(run, part):
    """The share of the traced span that is device idle time of ``part``."""
    tr = run.trace
    split = idle_split(tr)
    if split is None or not tr.ops:
        return None
    return 100 * split[part] / tr.window_s


def span_pct(run, name):
    """The share of the traced span inside the program's span ``name`` on
    any thread, or None where the trace holds no such span."""
    tr = run.trace
    if tr is None or not has(tr, lambda n: n == name):
        return None
    ivs = merge(iv for v in named(tr, lambda n: n == name).values()
                for iv in v)
    return 100 * length(ivs) / 1e9 / tr.window_s
