"""Spans on the torch profiler's own timeline.

``span(name)`` is a ``torch.profiler.record_function(name)`` while a torch
profiler is running and a shared no-op context otherwise, so the serving
session and the models mark their layers at no cost when nobody traces
them.  The profiler is the one sink: there is no buffer, exporter or switch
here.  A span shares the profiler's clock with the device operations, so an
idle stretch of the device can be put down to the host span around it
without offset arithmetic.

Trace a threads-engine session by running a profiler around it with every
thread recorded, and export the result to Perfetto::

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        ...                                  # submit, wait_all
    prof.export_chrome_trace("serve.json")

A span opened before the profiler started is not recorded; one still open
when it stops ends there.  Every span name starts with ``repro_torch.``:

* ``repro_torch.lm.job.<kind>`` (``prefill``, ``rebuild``, ``decode``,
  ``warm``): one executor job, on its executor's thread;
* ``repro_torch.lm.sync``: a job's copy of its result to the host, inside
  its job;
* ``repro_torch.lm.admit.prefill``: the scheduler's admission of a round's
  requests, from their prefills' submission to the last result;
* ``repro_torch.lm.admit.rebuild``: the scheduler's rebuild of one parity
  slot column, from its jobs' submission to the last result;
* ``repro_torch.moe.dispatch``: an MoE layer's routing, its scatter of
  tokens into the expert buffers and its gather back (``models/moe.py``).
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

_OFF = nullcontext()


def span(name):
    """A context that marks ``name`` on the running torch profiler's
    timeline, or the shared no-op context when no profiler runs (the check
    is the profiler's own module flag, which every thread sees)."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
