"""The traced span of a ``--trace 1`` run and its reduction.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities, every
thread) over a span of the run, and wraps the program functions that the
cell's metric readers name (``SPANS``) in annotations of their own,
``portbench.<key>:<call>``, recording what each reader's ``describe``
keeps of a call's arguments.

``reduce`` turns the profiler's events into ``TraceData``: every device
operation with its interval, the native id of the thread that launched it
(its runtime launch event has the same correlation id), the benchmark
annotations enclosing that launch, and the name of the aten op that
launched it (its linked correlation id; None for a kernel launched outside
an aten op, as the port's hand-written kernels are)."""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import itertools
import re
import threading
import time

import torch

PREFIX = "portbench."


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int                   # ns, the profiler's clock
    end: int
    tid: int                     # launching thread's native id, or -1
    spans: tuple                 # (key, call) of enclosing annotations
    op: str = None               # launching aten op's name


@dataclasses.dataclass
class TraceData:
    t_on: int
    t_off: int
    ops: list                    # DeviceOp, clipped to [t_on, t_off]
    calls: dict                  # key -> {call: described arguments}
    threads: dict                # native id -> thread name
    cpu: dict                    # native id -> sorted [(start, end, name)]

    @property
    def window_s(self):
        return (self.t_off - self.t_on) / 1e9

    def busy_intervals(self):
        out = []
        for o in sorted(self.ops, key=lambda o: o.start):
            if out and o.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], o.end)
            else:
                out.append([o.start, o.end])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_s(self, pick=None):
        return sum(o.end - o.start for o in self.ops
                   if pick is None or pick(o)) / 1e9

    def span_kernel_s(self, key):
        """{call: device seconds} of the operations launched inside the
        ``key`` annotation outside any aten op: the hand-written kernel a
        wrapped call launches, without the copies that ready its inputs."""
        out = {}
        for o in self.ops:
            if o.op is not None and o.op.startswith("aten::"):
                continue
            for k, call in o.spans:
                if k == key:
                    out[call] = out.get(call, 0.0) + (o.end - o.start) / 1e9
        return out

    def thread_of(self, name):
        return {t for t, n in self.threads.items() if n == name}

    def host_at(self, tid, t):
        """The innermost CPU event on thread ``tid`` running at ``t``."""
        evs = self.cpu.get(tid, [])
        i = bisect.bisect_right(evs, (t, float("inf"), "")) - 1
        best = None
        for j in range(i, max(-1, i - 4000), -1):
            s, e, name = evs[j]
            if e >= t and (best is None or s > best[0]):
                best = (s, e, name)
                break
        return best[2] if best else None

    def breakdown(self, n=10):
        """The device operations that took most time, and the longest idle
        gaps, each named by what the thread that launched the operation
        ending the gap was doing in its middle."""
        by_name = {}
        for o in self.ops:
            key = _short(o.name)
            by_name[key] = by_name.get(key, 0.0) + (o.end - o.start) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = self.busy_intervals()
        first = sorted(self.ops, key=lambda o: o.start)
        starts = [o.start for o in first]
        gaps = []
        edges = [(self.t_on, self.t_on)] + [tuple(b) for b in busy]
        for (a0, a1), (b0, b1) in zip(edges, edges[1:]):
            if b0 > a1:
                gaps.append((b0 - a1, a1, b0))
        gaps.sort(reverse=True)
        idle = []
        for length, a, b in gaps[:n]:
            nxt = first[bisect.bisect_left(starts, b)]
            what = self.host_at(nxt.tid, (a + b) // 2) or "python"
            idle.append(["host:" + _short(what), length / 1e9])
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": idle}


def _short(name, n=64):
    return re.sub(r"[^A-Za-z0-9_.:<>-]+", "_", name)[:n]


class Tracer:
    """Context manager over the traced span.  ``spans``: {key: (module,
    attribute, describe)}."""

    def __init__(self, spans):
        self.spans = spans
        self.calls = {key: {} for key in spans}
        self._ids = itertools.count()
        self._saved = []
        self.prof = None

    def _wrap(self, key, module, attr, describe):
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        calls = self.calls[key]
        ids = self._ids

        def wrapped(*args, **kwargs):
            i = next(ids)
            calls[i] = describe(*args, **kwargs)
            with torch.profiler.record_function(f"{PREFIX}{key}:{i}"):
                return orig(*args, **kwargs)
        setattr(mod, attr, wrapped)
        self._saved.append((mod, attr, orig))

    def __enter__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        for key, (module, attr, describe) in self.spans.items():
            self._wrap(key, module, attr, describe)
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()
        self.threads = {t.native_id: t.name for t in threading.enumerate()}
        self._span = torch.profiler.record_function(PREFIX + "trace")
        self._span.__enter__()
        self.t_on = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.t_off = time.monotonic()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()
        return False

    def reduce(self):
        """``TraceData`` of the span (call after the span and after the
        arguments the readers kept can be read)."""
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.calls, self.threads)


def _is_runtime(name):
    return name.startswith("cu") and "::" not in name


def reduce_events(events, calls, threads):
    gpu, runtime, ops, cpu = [], {}, {}, {}
    annots = {}
    t_on = t_off = None
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if not e.is_user_annotation():
                gpu.append((name, start, end, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        tid = e.device_resource_id()
        if _is_runtime(name):
            runtime[e.correlation_id()] = (tid, start)
            continue
        if e.is_user_annotation() and name.startswith(PREFIX):
            if name == PREFIX + "trace":
                t_on, t_off = start, end
            else:
                key, _, call = name[len(PREFIX):].rpartition(":")
                annots.setdefault(tid, []).append((start, end, (key,
                                                                int(call))))
            continue
        ops[e.correlation_id()] = name
        cpu.setdefault(tid, []).append((start, end, name))
    if t_on is None:
        raise RuntimeError("the trace holds no portbench.trace span")
    for lst in cpu.values():
        lst.sort()
    launches = {}
    for i, (name, s, e, corr, link) in enumerate(gpu):
        tid, t = runtime.get(corr, (-1, s))
        launches.setdefault(tid, []).append((t, i))
    spans = {}
    for tid, lst in launches.items():
        lst.sort()
        spans.update(_enclosing(sorted(annots.get(tid, []),
                                       key=lambda a: (a[0], -a[1])), lst))
    out = []
    for i, (name, s, e, corr, link) in enumerate(gpu):
        s, e = max(s, t_on), min(e, t_off)
        if e <= s:
            continue
        tid = runtime.get(corr, (-1, 0))[0]
        out.append(DeviceOp(name, s, e, tid, spans.get(i, ()),
                            ops.get(link) if link else None))
    return TraceData(t_on, t_off, out, calls, threads, cpu)


def _enclosing(annots, launches):
    """For launches [(t, i)] sorted by time on one thread, the (key, call)
    of every annotation (nested intervals, sorted by start) around each."""
    stack, j, out = [], 0, {}
    for t, i in launches:
        while j < len(annots) and annots[j][0] <= t:
            while stack and stack[-1][1] < annots[j][0]:
                stack.pop()
            stack.append(annots[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = tuple(a[2] for a in stack)
    return out
