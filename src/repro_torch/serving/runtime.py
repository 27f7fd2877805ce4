"""Threaded prediction-serving runtime with pluggable coded resilience.

A faithful (single-host) analogue of the paper's Clipper-based deployment:
a frontend with a single dispatch queue per pool (the load-balancing strategy
of §5.1), model-instance worker threads running real PyTorch inference, coding
groups of k consecutively dispatched query batches, frontend-side encode, and
on-unavailability decode. Slowdowns are injected per instance (sleep), since
the mitigation is agnostic to the cause (§2.2).

Which pools exist, how queries are grouped/mirrored, and what happens on
unavailability are owned by a ``ResilienceStrategy`` (``serving/strategy.py``)
and the code itself by a ``CodingScheme`` (``core/scheme.py``) — the same two
objects the DES in ``repro_torch.serving.simulator`` consumes, so the threaded and
simulated serving paths cannot drift. See DESIGN.md for the plugin API.

This module is the **threads engine** behind the declarative serving surface
in ``repro_torch.serving.api``: ``deploy(DeploymentSpec(...), engine="threads")``
constructs a ``ParMFrontend`` from the spec, and the legacy kwarg constructor
is a shim that folds its arguments into a ``DeploymentSpec`` first.  Two
serving-policy behaviors live here rather than in the strategy, because they
are properties of the *frontend*, not of the code:

* **adaptive batching** (``DeploymentSpec.batching``): main-pool workers
  dequeue up to ``max_size`` waiting queries per inference call (optionally
  holding the batch open ``max_delay_ms`` for late joiners), stack them along
  the batch dimension, and split the stacked output back per query;
* **redundant-work cancellation**: a queued query whose prediction already
  arrived (parity decode beat it, a mirror replica won, or the SLO default
  fired) is tombstoned and skipped at dequeue, and an undispatched parity
  query whose group has every original answered is dropped the same way —
  both counted in ``ServingReport.cancelled_queries`` /
  ``cancelled_parities``;
* **Byzantine screening**: under a corrupt-output scenario the workers'
  ``corrupt_fn`` adapter garbles real outputs (``CORRUPTION_SCALE``), and a
  ``detects_errors`` scheme (approxifer) votes recorded responses out via
  ``flag_errors`` whenever the group holds surplus responses — evicted
  responses never answer their query nor enter a decode; counts surface as
  ``ServingReport.corrupted_detected`` / ``corrected``;
* **closed-loop adaptation** (``DeploymentSpec.controller``): a registered
  ``Controller`` (``serving/controller.py``) observes fixed-length windows of
  the live signals (ticked at the top of ``submit`` on the scenario clock,
  trailing windows closed at shutdown) and emits ``Adjustment``s that retune
  scheme / r / batch size.  Adjustments land at the next coding-group
  boundary; in-flight groups keep the scheme/r they captured at assembly, so
  nothing is dropped mid-decode.  Parity pools are provisioned up front in
  two families: pools ``0..r-1`` run the deployment's own ``parity_params``,
  and ``Controller.escalation_r`` extra pools run the *deployed* parameters
  for escalated groups — a controller adjustment that is not an exact return
  to the deployment base must name a ``model_agnostic`` scheme (approxifer),
  whose parity input is a combination of plain queries, so the deployed
  model is its parity model; groups route to one family or the other by the
  scheme they captured.  The adjustment log uses the same tuples the DES
  records, so the differential battery compares decision sequences verbatim.

Used by the end-to-end example (examples/serve_parm.py) and integration tests;
the 100k-query tail studies use the DES in ``repro_torch.serving.simulator``.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.convert import to_host
from repro_torch.core.scheme import (get_scheme, recoverable_rows,
                                     scheme_capabilities)
from repro_torch.serving.api import BatchingPolicy, DeploymentSpec
from repro_torch.serving.controller import Adjustment, get_controller
from repro_torch.serving.report import ServingReport, build_window
from repro_torch.serving.scenarios import (CORRUPTION_SCALE, get_scenario,
                                           instance_id)
from repro_torch.serving.strategy import get_strategy

# worker-shutdown sentinel: one per worker is pushed onto its pool queue so a
# blocking ``get()`` wakes immediately — no idle polling, sub-ms shutdown
_SHUTDOWN = object()

# test hook for the batched multi-group decode drain (`_decode_touched`):
# None = batch whenever >1 recoverable group shares a scheme and shape,
# "batched" = route even a single group through the multigroup launch,
# "pergroup" = always decode per group (the pre-fusion path).  The fused /
# unfused differential test drives both settings through identical workloads
# and asserts identical ServingReport reconstruction counts.
_FORCE_DECODE: Optional[str] = None

# not-passed marker for the legacy kwarg surface: any kwarg the caller
# actually supplied is `is not _UNSET`, so spec-vs-kwargs conflict detection
# needs no shadow table of defaults
_UNSET = object()


def _dev(scheme, x):
    """A host array as a tensor on ``scheme``'s device (the hand-off into
    the scheme's encode/decode math)."""
    return torch.as_tensor(x, device=scheme.device)


@dataclass
class Query:
    qid: int
    data: np.ndarray
    arrival: float = 0.0
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    completed_by: str = ""
    finish: float = 0.0

    def fulfill(self, result, how, now=None):
        if not self.event.is_set():
            self.result = result
            self.completed_by = how
            self.finish = now or time.perf_counter()
            self.event.set()

    @property
    def latency_ms(self):
        return (self.finish - self.arrival) * 1e3


class ModelInstance(threading.Thread):
    """Worker pulling (tag, payload, x) items off a shared pool queue.

    ``skip_fn(tag, payload)`` — redundant-work tombstone check, consulted at
    dequeue (an item that became pointless while queued is dropped, never
    served).  ``batching`` — adaptive batching policy; when ``max_size > 1``
    the worker collects up to that many queued items per inference call,
    stacks them along the batch dim and splits the output back per item.
    ``on_done_batch([(payload, out), ...])`` — batch-atomic completion: the
    whole batch's outputs are handed over in ONE call, so the consumer can
    record every batch-mate before any decode decision runs (delivering them
    one at a time would let a parity decode "reconstruct" a member whose
    exact output sits later in the same batch).  ``on_batch(n)`` —
    bookkeeping callback, once per inference call.
    """

    def __init__(self, iid, pool_q, fwd, params, on_done,
                 delay_fn: Optional[Callable[[int], float]] = None,
                 skip_fn: Optional[Callable] = None,
                 batching: Optional[BatchingPolicy] = None,
                 on_batch: Optional[Callable[[int], None]] = None,
                 on_done_batch: Optional[Callable] = None,
                 corrupt_fn: Optional[Callable[[int], bool]] = None):
        super().__init__(daemon=True)
        self.iid = iid
        self.pool_q = pool_q
        self.fwd = fwd
        self.params = params
        self.on_done = on_done
        self.delay_fn = delay_fn
        self.skip_fn = skip_fn
        self.batching = batching
        self.on_batch = on_batch
        self.on_done_batch = on_done_batch
        self.corrupt_fn = corrupt_fn
        self.stop = False

    def _maybe_corrupt(self, out):
        """Byzantine injection (``corrupt_fn`` adapter, the ``delay_fn``
        twin): while a corrupt window is active on this instance, the
        response is garbage at ``CORRUPTION_SCALE`` — real numerical
        corruption the decode path must detect, not a flag."""
        if self.corrupt_fn is not None and self.corrupt_fn(self.iid):
            return np.full_like(out, CORRUPTION_SCALE)
        return out

    def _infer(self, x):
        """One inference call, returned as host numpy.  Runs under
        ``inference_mode``: parameters trained with autograd carry
        ``requires_grad``, and no worker needs a graph."""
        with torch.inference_mode():
            return to_host(self.fwd(self.params, x))

    def _collect(self, first):
        """Fill a batch: up to ``max_size`` items, holding the batch open at
        most ``max_delay_ms`` after the first dequeue (Clipper-style)."""
        items = [first]
        deadline = time.perf_counter() + self.batching.max_delay_ms / 1e3
        while len(items) < self.batching.max_size:
            wait = deadline - time.perf_counter()
            try:
                item = self.pool_q.get(timeout=wait) if wait > 0 \
                    else self.pool_q.get_nowait()
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                self.stop = True        # serve what we have, then exit
                break
            if self.skip_fn is not None and self.skip_fn(item[0], item[1]):
                continue                # tombstoned while queued
            items.append(item)
        return items

    def run(self):
        while not self.stop:
            item = self.pool_q.get()
            if item is _SHUTDOWN:
                break
            if self.stop:
                # shutdown raced our dequeue: abandon the item, but route it
                # through the same tombstone accounting the post-join queue
                # drain applies, so redundant work is still counted
                if self.skip_fn is not None:
                    self.skip_fn(item[0], item[1])
                continue
            if self.skip_fn is not None and self.skip_fn(item[0], item[1]):
                continue            # tombstoned while queued
            if self.batching is not None and self.batching.max_size > 1:
                items = self._collect(item)
            else:
                items = [item]
            if self.delay_fn:
                d = self.delay_fn(self.iid)
                if d > 0:
                    time.sleep(d)
            if len(items) == 1:
                tag, payload, x = items[0]
                out = self._maybe_corrupt(self._infer(x))
                if self.on_batch is not None:
                    self.on_batch(1)
                self.on_done(tag, payload, out)
            else:
                # one inference call per trailing-shape group: same-shape
                # queries stack along the leading batch dim and the output
                # splits back per item.  Mixed shapes are NOT padded — for a
                # general fwd, padding would change the outputs — they just
                # cost one extra call, instead of a ValueError that would
                # kill the worker and hang every dequeued future
                groups = {}
                for i, it in enumerate(items):
                    groups.setdefault(np.shape(it[2])[1:], []).append(i)
                outs = [None] * len(items)
                for idxs in groups.values():
                    stacked = np.concatenate([items[i][2] for i in idxs],
                                             axis=0)
                    out = self._maybe_corrupt(self._infer(stacked))
                    if self.on_batch is not None:
                        self.on_batch(len(idxs))
                    ofs = 0
                    for i in idxs:
                        sz = items[i][2].shape[0]
                        outs[i] = out[ofs:ofs + sz]
                        ofs += sz
                if self.on_done_batch is not None:
                    self.on_done_batch(
                        [(it[1], o) for it, o in zip(items, outs)])
                else:
                    for (tag, payload, _), o in zip(items, outs):
                        self.on_done(tag, payload, o)


class ParMFrontend:
    """Frontend: group assembly, encode, dispatch, decode-on-unavailability.

    The canonical constructor is ``ParMFrontend(spec=DeploymentSpec(...))``
    (what ``repro_torch.serving.api.deploy`` calls); the legacy kwarg surface keeps
    working by folding its arguments into a spec first.

    ``strategy`` — a ``ResilienceStrategy`` or registered name
    (``parm`` | ``equal_resources`` | ``replication`` | ``approx_backup`` |
    ``default_slo`` | ``none``); owns pool layout and unavailability behavior.
    ``scheme`` — a ``CodingScheme`` or registered name (``sum`` | ``concat`` |
    ``replication`` | ``approx_backup``); owns encode/decode
    AND the coding-group size: groups are assembled with ``scheme.k``
    queries, which a ``fixes_k`` scheme (approx_backup: k = 1, one cheap
    backup query per group) decouples from the redundancy-budget ``k`` that
    sizes the pools. ``backend`` selects the torch or CUDA-kernel hot path
    when ``scheme`` is given by name.

    The PR-1-era ``mode=`` and ``backup_params=`` kwargs are REMOVED: they
    raise ``TypeError`` with a migration message (``strategy=`` /
    ``parity_params=``).
    """

    def __init__(self, fwd=_UNSET, deployed_params=_UNSET,
                 parity_params=_UNSET, *, k=_UNSET, r=_UNSET, m=_UNSET,
                 strategy=_UNSET, scheme=_UNSET, backend=_UNSET, mode=_UNSET,
                 delay_fn=_UNSET, encode_fn=_UNSET, decode_fn=_UNSET,
                 default_prediction=_UNSET, slo_ms=_UNSET,
                 backup_params=_UNSET, parity_fwd=_UNSET, scenario=_UNSET,
                 scenario_seed=_UNSET, scenario_time_scale=_UNSET,
                 scenario_horizon_ms=_UNSET, batching=_UNSET,
                 spec: Optional[DeploymentSpec] = None):
        """``r > 1`` (paper §3.5): ``parity_params`` is a list of r parity
        models, each trained to the j-th Vandermonde combination; r parity
        queries are dispatched per coding group and the decoder solves the
        linear system for up to r concurrent unavailabilities. ``r`` and
        ``backend`` default to the scheme's own values when a scheme
        *instance* is passed; an explicit mismatch raises.

        ``parity_fwd`` — forward function for the parity-pool workers when
        the parity model is a *different architecture* from the deployed
        model (the approx_backup scheme's cheap backup model); defaults to
        ``fwd``.

        ``scenario`` — a fault ``Scenario`` (instance or registered name from
        ``repro_torch.serving.scenarios``, e.g. ``"crash"``); its hazards are
        realized once and injected as per-instance delays through the same
        windows the DES applies, composing with any user ``delay_fn``.
        ``scenario_time_scale`` maps scenario milliseconds to wall-clock
        milliseconds (1.0 = real time); recurring hazards are realized out
        to ``scenario_horizon_ms`` sim-ms, so injection stops after
        ``scenario_horizon_ms * scenario_time_scale`` wall-clock ms —
        raise it for longer experiments."""
        passed = {name: v for name, v in {
            "fwd": fwd, "deployed_params": deployed_params,
            "parity_params": parity_params, "k": k, "r": r, "m": m,
            "strategy": strategy, "scheme": scheme, "backend": backend,
            "delay_fn": delay_fn, "encode_fn": encode_fn,
            "decode_fn": decode_fn,
            "default_prediction": default_prediction, "slo_ms": slo_ms,
            "parity_fwd": parity_fwd,
            "scenario": scenario, "scenario_seed": scenario_seed,
            "scenario_time_scale": scenario_time_scale,
            "scenario_horizon_ms": scenario_horizon_ms,
            "batching": batching}.items() if v is not _UNSET}
        # PR-1-era spellings: removed after one deprecation release
        if mode is not _UNSET:
            raise TypeError(
                "ParMFrontend(mode=...) was removed; pass strategy= (a "
                "registered ResilienceStrategy name or instance)")
        if backup_params is not _UNSET:
            raise TypeError(
                "ParMFrontend(backup_params=...) was removed; approximate "
                "backups are the coded 'approx_backup' scheme — pass "
                "parity_params= (and parity_fwd= for a cheaper "
                "architecture)")
        if spec is None:
            # legacy kwarg surface: remap the old spellings, then build the
            # spec from ONLY the kwargs actually passed — every default
            # comes from DeploymentSpec itself, so the two construction
            # surfaces cannot drift
            kw = dict(passed)
            if "deployed_params" in kw:
                kw["params"] = kw.pop("deployed_params")
            if kw.get("batching") is None:         # legacy "no policy"
                kw.pop("batching", None)
            spec = DeploymentSpec(**kw)
            warnings.warn(
                "the ParMFrontend kwarg surface is a legacy shim; build a "
                "DeploymentSpec and use repro_torch.serving.api.deploy (or "
                "ParMFrontend(spec=...))", DeprecationWarning, stacklevel=2)
        elif passed:
            # a legacy kwarg next to spec= would be silently ignored —
            # deploying with different semantics than the caller wrote
            raise TypeError(
                f"pass either spec= or the legacy kwargs, not both "
                f"(also got {sorted(passed)})")
        self.spec = spec
        self._build(spec)

    # ------------------------------------------------------------------
    def _build(self, spec: DeploymentSpec):
        if spec.fwd is None or spec.params is None:
            # fail at construction, not as a worker-thread crash that only
            # surfaces as futures hanging until their timeout
            raise ValueError(
                "ParMFrontend runs real inference: fwd= and "
                "deployed_params= (spec.fwd / spec.params) are required")
        fwd, m, k = spec.fwd, spec.m, spec.k
        self.strategy = get_strategy(spec.strategy)
        scheme = spec.scheme
        if scheme is None:
            scheme = self.strategy.scheme or "sum"
        # validates k / r / backend against scheme instances
        self.scheme = get_scheme(scheme, k=k, r=spec.r, backend=spec.backend,
                                 device=spec.device)
        self.k = k
        # group assembly follows the scheme's own group size: a fixes_k
        # scheme (approx_backup) decouples it from the budget k
        self.group_k = self.scheme.k if self.strategy.coded else k
        # a scheme may fix its own parity count (replication: r = k)
        self.r = self.scheme.r if self.strategy.coded else \
            (1 if spec.r is None else spec.r)
        # the deployment's own resolved scheme OBJECT: controller
        # de-escalation restores this instance (not a fresh registry
        # default under the same name), and group dispatch routes by
        # identity against it
        self._base_scheme = self.scheme
        self._base_r = self.r
        self.batching = spec.batching
        self._controller = None if spec.controller is None else \
            get_controller(spec.controller)
        # Parity pools exist from construction (worker threads cannot be
        # spawned mid-run), in TWO families:
        #   pools 0 .. r-1             — the deployment's own parity models;
        #   pools r .. r+agn_r-1       — escalation pools running the
        #                                *deployed* parameters, sized by
        #                                Controller.escalation_r.
        # Every controller adjustment that is not an exact return to the
        # deployment base dispatches to the second family — its scheme must
        # be model_agnostic (parity input is a combination of plain
        # queries), so the deployed model IS its parity model.  The base
        # family never serves an escalated group: its pools run trained
        # parity models (e.g. ParM 'sum') whose outputs another code's
        # decoder must not consume.
        self._agn_base = self.r
        self._agn_r = 0
        if self._controller is not None and self.strategy.coded:
            esc = getattr(self._controller, "escalation_r",
                          self._controller.max_r)
            self._agn_r = max(0, int(esc(self.r)))
        self.r_pools = self.r + self._agn_r
        self._user_encode = spec.encode_fn
        self.encode_fn = spec.encode_fn or (
            lambda q: to_host(self.scheme.encode(_dev(self.scheme, q))))
        self.decode_fn = spec.decode_fn
        self.default_prediction = spec.default_prediction
        self.slo_ms = spec.slo_ms
        self.queries = {}
        self.groups = {}   # gid -> {"members", "outs", "parity": {j: out}}
        self.gid_of = {}
        self.lock = threading.Lock()
        self._next_gid = 0
        self._pending_group = []
        self._early_outs = {}   # outputs that beat their group's assembly
        self._timers = set()    # armed default_slo timers; cancelled at
                                # shutdown so none fires into a dead frontend
        self._shutdown = False
        self.cancelled_queries = 0    # tombstoned originals skipped at dequeue
        self.cancelled_parities = 0   # undispatched parities dropped
        self._n_batches = 0           # main-pool inference calls
        self._n_batch_queries = 0     # queries those calls carried
        # Byzantine bookkeeping: responses the scheme voted out, and how
        # many of the affected predictions were served clean regardless.
        # _detecting is finalized below once the scenario adapters exist:
        # screening only runs when corruption can actually be injected
        self._detecting = False
        self.corrupted_detected = 0
        self.corrupted_corrected = 0
        # controller bookkeeping: the window clock runs in *scenario* ms
        # (wall-clock since construction divided by scenario_time_scale),
        # ticked at the top of submit() and drained at shutdown
        self._origin = time.perf_counter()
        self._adjust_log = []
        self._pending_adj = None        # (Adjustment, window_index) deferred
                                        # to the next group boundary
        self._window_idx = 0
        self._window_counted = set()    # qids already bucketed in a window
        self._ctl_prev = {"detected": 0, "cancel": 0}
        self._last_submit_ms = 0.0
        self._ctl_state = None
        self.parity_served = 0          # parity inference items served

        layout = self.strategy.layout(m, k, self.r)
        scenario = spec.scenario
        if scenario is None:
            scenario = self.strategy.scenario
        self.scenario = None
        delay_fn = spec.delay_fn
        corrupt_fn = None
        if scenario is not None:
            # fault-injection adapters off ONE realized plan: the
            # scenario's hazard windows become per-instance delays
            # (composed with any user delay_fn), and its corrupt windows
            # per-instance output corruption
            self.scenario = get_scenario(scenario)
            pool_sizes = {"main": layout.main}
            if self.strategy.coded and layout.parity:
                for j in range(self.r_pools):
                    pool_sizes[f"parity{j}"] = layout.parity
            delay_fn, corrupt_fn = self.scenario.adapters(
                pool_sizes, seed=spec.scenario_seed,
                horizon_ms=spec.scenario_horizon_ms,
                time_scale=spec.scenario_time_scale, extra=delay_fn)
        # screening costs an lstsq vote under the frontend lock per
        # arrival once a group holds surplus responses — only pay it when
        # corruption can actually exist (the DES gates its revote on a
        # non-empty candidate set the same way)
        self._corrupting = corrupt_fn is not None
        self._detecting = self.strategy.coded and \
            scheme_capabilities(self.scheme).detects_errors and \
            corrupt_fn is not None
        self.main_q = queue.Queue()
        self.workers = []
        self._main_workers = []
        # a controller may retune max_size at runtime, so its main workers
        # always carry the (rebindable) policy object; run() re-reads
        # max_size every dequeue, so a max_size=1 policy batches nothing
        main_batching = self.batching if (
            self.batching.max_size > 1
            or self._controller is not None) else None
        for i in range(layout.main):
            w = ModelInstance(instance_id("main", i), self.main_q, fwd,
                              spec.params, self._on_model_done, delay_fn,
                              skip_fn=self._should_skip,
                              batching=main_batching,
                              on_batch=self._note_batch,
                              on_done_batch=self._on_model_batch_done,
                              corrupt_fn=corrupt_fn)
            w.start()
            self.workers.append(w)
            self._main_workers.append(w)
        if self.strategy.coded:
            parity_params = spec.parity_params
            if parity_params is None:
                # replication-style schemes: the "parity model" is the
                # deployed model itself (decode is a passthrough)
                parity_params = [spec.params] * self.r
            elif not isinstance(parity_params, (list, tuple)):
                parity_params = [parity_params]
            assert len(parity_params) == self.r, \
                (len(parity_params), self.r)
            # escalation pools run the DEPLOYED model end to end: plain
            # fwd + spec.params, never spec.parity_fwd (which may be a
            # different cheap-backup architecture trained for the base
            # code) — a model_agnostic scheme's parity input is a
            # combination of plain queries, so the deployed model IS its
            # parity model
            parity_params = list(parity_params) + \
                [spec.params] * self._agn_r
            self.parity_qs = []
            for j in range(self.r_pools):
                pq = queue.Queue()
                self.parity_qs.append(pq)
                p_fwd = (spec.parity_fwd or fwd) if j < self.r else fwd
                for i in range(layout.parity):
                    w = ModelInstance(instance_id(f"parity{j}", i), pq,
                                      p_fwd,
                                      parity_params[j],
                                      self._on_parity_done, delay_fn,
                                      skip_fn=self._should_skip,
                                      corrupt_fn=corrupt_fn)
                    w.start()
                    self.workers.append(w)
            self.parity_q = self.parity_qs[0]      # back-compat alias
        if self._controller is not None:
            # the base the controller's de-escalation returns to: the
            # deployment's own knobs (same construction as the DES)
            self._ctl_state = self._controller.init(Adjustment(
                scheme=self.scheme.name if self.strategy.coded else None,
                r=self.r if self.strategy.coded else None,
                batch_max_size=self.batching.max_size))

    # ----------------------------------------------------- controller ---
    def _ctl_tick(self, now):
        """Advance the window clock to ``now`` (wall-clock seconds),
        closing every observation window that has fully elapsed.  Runs at
        the top of ``submit`` — the same clock edge the DES models by
        sorting its ctl events ahead of same-time arrivals."""
        ts = self.spec.scenario_time_scale
        now_ms = (now - self._origin) * 1e3 / ts
        with self.lock:
            self._last_submit_ms = max(self._last_submit_ms, now_ms)
        while self._close_window(now_ms):
            pass

    def _close_window(self, now_ms=None):
        """Close window ``[widx*wlen, (widx+1)*wlen)``: bucket completions
        by completion timestamp (scenario ms), counters by per-window
        delta, hand the window to the controller, and apply its adjustment
        — immediately when no group is assembling, else deferred to the
        next group boundary.  Latencies are reported in scenario ms so
        controller thresholds mean the same thing on both engines.

        Returns ``True`` iff a window was closed.  The elapsed check runs
        UNDER the lock: two concurrent ``submit()``s may both observe an
        expired window outside any lock, race into this method, and the
        loser must not close the *next* window early — it re-reads
        ``_window_idx`` under the lock and bails when the winner already
        advanced it past ``now_ms``.  ``now_ms=None`` is the shutdown
        drain: close windows out to the last submit, then stop."""
        ctl = self._controller
        ts = self.spec.scenario_time_scale
        wlen = float(ctl.window_ms)
        with self.lock:
            widx = self._window_idx
            t1 = (widx + 1) * wlen
            if now_ms is not None:
                if t1 > now_ms:
                    return False
            elif widx * wlen >= self._last_submit_ms:
                return False
            recs = []
            for qid, q in self.queries.items():
                if qid in self._window_counted or not q.event.is_set() \
                        or q.completed_by == "flushed":
                    continue
                fin_ms = (q.finish - self._origin) * 1e3 / ts
                if fin_ms < t1:
                    self._window_counted.add(qid)
                    recs.append((q.latency_ms / ts,
                                 q.completed_by == "parity"))
            cancel = self.cancelled_queries + self.cancelled_parities
            win = build_window(
                widx, widx * wlen, t1, recs,
                corrupted_detected=self.corrupted_detected
                - self._ctl_prev["detected"],
                cancellations=cancel - self._ctl_prev["cancel"])
            self._ctl_prev["detected"] = self.corrupted_detected
            self._ctl_prev["cancel"] = cancel
            adj, self._ctl_state = ctl.observe(self._ctl_state, win)
            self._window_idx = widx + 1
            if adj is not None:
                if self._pending_group:
                    self._pending_adj = (adj, widx)
                else:
                    self._apply_adjustment(adj, widx)
        return True

    def _apply_adjustment(self, adj, widx):
        """Lock held.  Retune the CURRENT knobs; in-flight groups keep the
        scheme/r/det they captured at assembly.  Scheme/r apply only to
        coded strategies; batching to any.  The log records the
        post-adjustment knobs — the identical tuples the DES appends, so
        the differential battery compares decision sequences verbatim."""
        if self.strategy.coded and (adj.scheme is not None
                                    or adj.r is not None):
            name = adj.scheme if adj.scheme is not None \
                else self.scheme.name
            want_r = adj.r if adj.r is not None else self.r
            if name == self._base_scheme.name and want_r == self._base_r:
                # de-escalation: restore the deployment's own scheme
                # INSTANCE — re-resolving by name would silently swap a
                # non-default-configured scheme for a registry default,
                # and identity (`is`) is what routes groups back to the
                # trained parity pools
                new = self._base_scheme
            else:
                new = get_scheme(name, k=self.k, r=want_r,
                                 backend=self.spec.backend,
                                 device=self.spec.device)
                if not scheme_capabilities(new).model_agnostic:
                    # escalation pools run the deployed parameters; a
                    # trained-parity scheme's decoder would consume the
                    # wrong model's outputs and serve numerically wrong
                    # reconstructions
                    raise ValueError(
                        f"controller adjustment to scheme {name!r} "
                        f"(r={new.r}) is not the deployment base and not "
                        f"model_agnostic — runtime escalation can only "
                        f"target schemes whose parity pool runs the "
                        f"deployed parameters")
                if new.r > self._agn_r:
                    raise ValueError(
                        f"controller adjustment needs r={new.r} "
                        f"escalation pools but only {self._agn_r} were "
                        f"provisioned — raise Controller.escalation_r")
            self.scheme, self.r, self.group_k = new, new.r, new.k
            self._detecting = scheme_capabilities(new).detects_errors and \
                self._corrupting
        if adj.batch_max_size is not None:
            self.batching = replace(self.batching,
                                    max_size=max(1, adj.batch_max_size))
            for w in self._main_workers:
                w.batching = self.batching
        self._adjust_log.append(
            (widx,
             self.scheme.name if self.strategy.coded else None,
             self.r if self.strategy.coded else None,
             self.batching.max_size))

    # ------------------------------------------------------------------
    def submit(self, qid, x):
        """x: one query batch (leading batch dim, usually 1)."""
        q = Query(qid, x, arrival=time.perf_counter())
        if self._controller is not None:
            self._ctl_tick(q.arrival)
        to_encode = None
        with self.lock:
            if self._shutdown:
                # the workers already consumed their shutdown sentinels —
                # enqueuing now would hand back a future that hangs until
                # its timeout instead of failing fast
                raise RuntimeError(
                    "ParMFrontend is shut down; deploy a new session")
            self.queries[qid] = q
            if self.strategy.coded:
                self._pending_group.append(qid)
                self.gid_of[qid] = self._next_gid
                if len(self._pending_group) == self.group_k:
                    gid = self._next_gid
                    members = list(self._pending_group)
                    self._pending_group.clear()
                    self._next_gid += 1
                    # outputs that finished before the group existed
                    outs = {m: self._early_outs.pop(m) for m in members
                            if m in self._early_outs}
                    # capture the CURRENT knobs: a controller adjustment
                    # landing later retunes only subsequent groups — this
                    # one decodes under the scheme/r it was encoded with
                    self.groups[gid] = {"members": members, "outs": outs,
                                        "parity": {}, "corrupt_m": set(),
                                        "scheme": self.scheme,
                                        "r": self.r,
                                        "det": self._detecting}
                    to_encode = (gid, np.stack(
                        [self.queries[m].data for m in members]),
                        self.scheme, self.r)
                    if self._pending_adj is not None:
                        # a deferred adjustment lands exactly at this
                        # group boundary — the DES applies it at the same
                        # edge of its event clock
                        adj, widx = self._pending_adj
                        self._pending_adj = None
                        self._apply_adjustment(adj, widx)
            # enqueue under the same lock as the _shutdown check: a
            # concurrent shutdown() either sees these items in its queue
            # drain, or this submit already raised — never an item enqueued
            # onto dead workers after the drain
            for _ in range(self.strategy.mirror):
                self.main_q.put(("query", qid, x))
        if to_encode is not None:
            # frontend-side encode (1/k network overhead, §3.1); r parity
            # queries, one per parity model (§3.5). Runs outside the lock —
            # a device round trip here would stall every completion callback —
            # which is safe because no parity output for this gid can arrive
            # before these puts
            gid, stacked, g_scheme, g_r = to_encode
            # encode under the scheme the GROUP captured — self.scheme may
            # already point at a controller-adjusted one.  A user encode_fn
            # encodes the DEPLOYMENT's code: groups captured under a
            # controller-escalated scheme must use that scheme's own
            # encoder, or decode would consume parities of the wrong code.
            base = g_scheme is self._base_scheme
            if self._user_encode is not None and base:
                parities = np.asarray(self._user_encode(stacked))
            else:
                parities = to_host(g_scheme.encode(_dev(g_scheme, stacked)))
            # routing: base-scheme groups go to the trained parity pools
            # 0..r-1; escalated groups to the deployed-params escalation
            # pools at offset _agn_base — a trained parity model's outputs
            # must never enter another code's decoder
            ofs = 0 if base else self._agn_base
            with self.lock:
                dead = self._shutdown
                if not dead:
                    for j in range(g_r):
                        self.parity_qs[ofs + j].put(("parity", (gid, j),
                                                     parities[j]))
            if dead:
                # shutdown won the race while we encoded: flush this
                # group's unanswered members like any shutdown leftover
                # instead of leaving their futures to hang
                for m in self.groups[gid]["members"]:
                    q_ = self.queries.get(m)
                    if q_ is not None and not q_.event.is_set():
                        q_.fulfill(self.default_prediction, "flushed")
        if self.strategy.slo_default and self.slo_ms is not None:
            t = threading.Timer(self.slo_ms / 1e3, self._default_fire)
            t.args = (qid, t)
            t.daemon = True
            with self.lock:
                if not self._shutdown:
                    self._timers.add(t)
                    t.start()
        return q

    def _default_fire(self, qid, timer):
        with self.lock:
            # guard against firing into a torn-down frontend: shutdown()
            # cancels armed timers and flips the flag first
            if self._shutdown:
                return
            self._timers.discard(timer)
            q = self.queries.get(qid)
        if q is not None:
            q.fulfill(self.default_prediction, "default")

    # ------------------------------------------------------------------
    def _should_skip(self, tag, payload):
        """Redundant-work tombstone check, called by workers at dequeue.

        An *original* whose prediction already arrived (parity decode won,
        a mirror replica won, or the SLO default fired) is skipped; an
        undispatched *parity* query whose group has every original answered
        is dropped.  Mirrors the DES's dequeue-time cancellation exactly.
        """
        with self.lock:
            if tag == "query":
                q = self.queries.get(payload)
                if q is not None and q.event.is_set():
                    self.cancelled_queries += 1
                    return True
                return False
            # tag == "parity": payload is (gid, j)
            info = self.groups.get(payload[0])
            if info is not None and all(
                    self.queries[m].event.is_set()
                    for m in info["members"]):
                self.cancelled_parities += 1
                return True
            return False

    def _note_batch(self, n):
        with self.lock:
            self._n_batches += 1
            self._n_batch_queries += n

    # ------------------------------------------------------------------
    def _on_model_done(self, tag, qid, out):
        """Single-item completion: the batch-atomic path with one pair."""
        del tag
        self._on_model_batch_done([(qid, out)])

    def _on_model_batch_done(self, pairs):
        """Batch-atomic completion for adaptive batching: record EVERY
        batch-mate's output before any decode decision runs.  Delivering
        the outputs one `_on_model_done` at a time would let the first
        member's `_maybe_decode` treat a batch-mate as missing — and fulfill
        it with an approximate parity reconstruction — even though its exact
        output was computed in the very same inference call."""
        if not self.strategy.coded:
            for qid, out in pairs:
                self.queries[qid].fulfill(out, "model")
            return
        with self.lock:
            touched = {}
            for qid, out in pairs:
                gid = self.gid_of.get(qid)
                info = self.groups.get(gid)
                if info is not None:
                    info["outs"][qid] = out
                    touched[gid] = info
                else:
                    self._early_outs[qid] = out
            # Byzantine screening BEFORE fulfillment: a recorded output a
            # detects_errors scheme votes out must neither answer its own
            # query nor poison later decodes of its group-mates
            for gid, info in touched.items():
                self._screen(info)
            for qid, out in pairs:
                gid = self.gid_of.get(qid)
                info = self.groups.get(gid)
                if info is not None and qid in info["corrupt_m"] and \
                        qid not in info["outs"]:
                    continue        # voted out; _maybe_decode serves it
                self.queries[qid].fulfill(out, "model")
            self._decode_touched(touched)

    def _on_parity_done(self, tag, key, out):
        gid, j = key
        with self.lock:
            self.parity_served += 1     # parity inference actually ran —
                                        # the resource axis of the
                                        # adaptive-redundancy frontier
            info = self.groups.get(gid)
            if info is None:
                return
            info["parity"][j] = out
            self._screen(info)
            self._maybe_decode(gid, info)

    def _recoverable(self, scheme, miss_mask, parity_avail):
        """Which missing rows can be reconstructed now? Delegates to the
        shared ``recoverable_rows`` rule — the same function the DES consults
        — so the two serving layers cannot drift on decode decisions.
        ``scheme`` is the one the GROUP captured at assembly, not the
        frontend's (possibly controller-adjusted) current one."""
        return recoverable_rows(scheme, miss_mask, parity_avail)

    def _screen(self, info):
        """Byzantine vote (``detects_errors`` schemes), with the lock held,
        after new responses were recorded: hand the group's recorded
        responses to ``scheme.flag_errors`` and evict whatever it votes
        out, so a corrupted response neither answers its own query nor
        poisons later decodes of its group-mates.  A voted-out member the
        clean remainder can re-decode right now is left missing for
        ``_maybe_decode`` (which serves it clean and counts it corrected);
        one it cannot is fulfilled with the suspect output — detected but
        uncorrectable, matching the DES's end-of-run drain.  A voted-out
        response whose query was already answered counts as corrected only
        if that answer came from a clean parity reconstruction."""
        if not info["det"]:
            return
        members = info["members"]
        g_scheme, g_r = info["scheme"], info["r"]
        mo, po = info["outs"], info["parity"]
        member_avail = np.array([m in mo for m in members])
        parity_avail = np.array([j in po for j in range(g_r)])
        if member_avail.sum() + parity_avail.sum() <= len(members):
            return                      # no surplus: nothing to vote with
        ref = next(iter(mo.values())) if mo else next(iter(po.values()))
        zeros = np.zeros_like(ref)
        mouts = np.stack([mo.get(m, zeros) for m in members])
        pouts = np.stack([po.get(j, zeros) for j in range(g_r)])
        mflags, pflags = g_scheme.flag_errors(
            mouts, member_avail, pouts, parity_avail)
        for j in np.nonzero(pflags)[0]:
            # eviction is the whole effect: an absent parity can neither be
            # re-delivered nor re-flagged, so no set tracks it
            po.pop(int(j), None)
            self.corrupted_detected += 1
        for i in np.nonzero(mflags)[0]:
            m = members[int(i)]
            out = mo.pop(m)
            info["corrupt_m"].add(m)
            self.corrupted_detected += 1
            q = self.queries[m]
            if q.event.is_set():
                if q.completed_by == "parity":
                    self.corrupted_corrected += 1
                continue
            miss = np.array([mm not in mo for mm in members])
            pa = np.array([j in po for j in range(g_r)])
            if not self._recoverable(g_scheme, miss, pa)[int(i)]:
                # uncorrectable: serve the suspect output rather than hang
                q.fulfill(out, "model")

    def _decode_plan(self, info):
        """Decode decision for one group, with the lock held: returns
        ``(missing, miss_mask, parity_avail)`` — or None when nothing
        recoverable is still unanswered.  A member is missing when the group
        holds no (trustworthy) response for it — a voted-out corrupt
        response leaves its member missing even though the query may already
        be answered, so the decoder never feeds known-bad data (or
        placeholder zeros) into a reconstruction."""
        if not info["parity"]:
            return None
        members = info["members"]
        g_scheme, g_r = info["scheme"], info["r"]
        miss_mask = np.array([m not in info["outs"] for m in members])
        parity_avail = np.array([j in info["parity"]
                                 for j in range(g_r)])
        miss_mask = self._recoverable(g_scheme, miss_mask, parity_avail)
        # only still-unanswered members need serving; answered ones stay in
        # miss_mask so the decode math never uses their absent/evicted data
        missing = [m for m, miss in zip(members, miss_mask)
                   if miss and not self.queries[m].event.is_set()]
        if not missing:
            return None
        return missing, miss_mask, parity_avail

    def _fulfill_clean(self, info, m, recon):
        q = self.queries[m]
        newly = not q.event.is_set()
        q.fulfill(recon, "parity")
        if newly and m in info["corrupt_m"]:
            # this member's own response was voted out as corrupted;
            # it was just served from a clean reconstruction instead
            self.corrupted_corrected += 1

    def _group_outs(self, info):
        """Member outputs stacked [k, ...] (zeros at missing slots — masked
        out of the decode math by the availability coefficients)."""
        any_out = next(iter(info["parity"].values()))
        return np.stack([info["outs"].get(m, np.zeros_like(any_out))
                         for m in info["members"]])

    def _is_fast_plan(self, info, plan):
        """Does this group's decode land on the r=1 subtraction fast path
        (the batchable ``decode_one`` shape)?"""
        missing, miss_mask, _ = plan
        return info["r"] == 1 and len(missing) == 1 and \
            miss_mask.sum() == 1

    def _decode_group(self, info, plan):
        """Per-group decode execution (r=1 fast path: subtraction decoder;
        otherwise the scheme's general masked decode)."""
        missing, miss_mask, parity_avail = plan
        members = info["members"]
        g_scheme, g_r = info["scheme"], info["r"]
        outs = self._group_outs(info)
        if self._is_fast_plan(info, plan):
            j = members.index(missing[0])
            if self.decode_fn is not None:
                recon = self.decode_fn(info["parity"][0], outs, j)
            else:
                recon = to_host(g_scheme.decode_one(
                    _dev(g_scheme, info["parity"][0]), _dev(g_scheme, outs),
                    j))
            self._fulfill_clean(info, missing[0], recon)
            return
        any_out = next(iter(info["parity"].values()))
        parity_outs = np.stack([
            info["parity"].get(j, np.zeros_like(any_out))
            for j in range(g_r)])
        recon = to_host(g_scheme.decode(
            _dev(g_scheme, parity_outs), _dev(g_scheme, outs),
            _dev(g_scheme, miss_mask), _dev(g_scheme, parity_avail)))
        for m in missing:
            self._fulfill_clean(info, m, recon[members.index(m)])

    def _maybe_decode(self, gid, info):
        """Called with lock held: reconstruct up to ``n_parities_arrived``
        missing predictions for ONE group (the single-group entry point —
        parity arrivals; batch-atomic completions drain through
        ``_decode_touched``)."""
        del gid
        plan = self._decode_plan(info)
        if plan is not None:
            self._decode_group(info, plan)

    def _decode_touched(self, touched):
        """Batched decode drain for a batch-atomic completion, with the lock
        held: gather EVERY touched group's decode decision first, then
        reconstruct all recoverable groups together — fast-path (r=1,
        one-missing) groups sharing a scheme instance and output shape go
        through ONE ``decode_one_many`` multigroup launch, general-path
        groups sharing a scheme through one vmapped ``decode_many`` solve;
        schemes without the batched surface (or a user ``decode_fn``, or
        ``_FORCE_DECODE="pergroup"``) keep the exact per-group path."""
        plans = []
        for gid, info in touched.items():
            plan = self._decode_plan(info)
            if plan is not None:
                plans.append((info, plan))
        batch_min = 1 if _FORCE_DECODE == "batched" else 2
        if _FORCE_DECODE == "pergroup" or len(plans) < batch_min:
            for info, plan in plans:
                self._decode_group(info, plan)
            return
        fast, general, rest = {}, {}, []
        for info, plan in plans:
            g_scheme = info["scheme"]
            shape = next(iter(info["parity"].values())).shape
            if self._is_fast_plan(info, plan) and self.decode_fn is None \
                    and hasattr(type(g_scheme), "decode_one_many"):
                fast.setdefault((id(g_scheme), shape), []).append(
                    (info, plan))
            elif hasattr(type(g_scheme), "decode_many"):
                general.setdefault((id(g_scheme), shape), []).append(
                    (info, plan))
            else:
                rest.append((info, plan))
        for bucket in fast.values():
            if len(bucket) < batch_min:
                rest.extend(bucket)
                continue
            g_scheme = bucket[0][0]["scheme"]
            idxs = [info["members"].index(plan[0][0])
                    for info, plan in bucket]
            parity_outs = np.stack([info["parity"][0]
                                    for info, _ in bucket])
            outs = np.stack([self._group_outs(info)
                             for info, _ in bucket])
            recons = to_host(g_scheme.decode_one_many(
                _dev(g_scheme, parity_outs), _dev(g_scheme, outs),
                np.asarray(idxs)))
            for (info, plan), recon in zip(bucket, recons):
                self._fulfill_clean(info, plan[0][0], recon)
        for bucket in general.values():
            if len(bucket) < batch_min:
                rest.extend(bucket)
                continue
            g_scheme = bucket[0][0]["scheme"]
            g_r = bucket[0][0]["r"]
            any_out = next(iter(bucket[0][0]["parity"].values()))
            parity_outs = np.stack([
                np.stack([info["parity"].get(j, np.zeros_like(any_out))
                          for j in range(g_r)]) for info, _ in bucket])
            outs = np.stack([self._group_outs(info)
                             for info, _ in bucket])
            miss = np.stack([plan[1] for _, plan in bucket])
            pa = np.stack([plan[2] for _, plan in bucket])
            recons = to_host(g_scheme.decode_many(
                _dev(g_scheme, parity_outs), _dev(g_scheme, outs),
                _dev(g_scheme, miss), _dev(g_scheme, pa)))
            for (info, plan), recon in zip(bucket, recons):
                members = info["members"]
                for m in plan[0]:
                    self._fulfill_clean(info, m, recon[members.index(m)])
        for info, plan in rest:
            self._decode_group(info, plan)

    # ------------------------------------------------------------------
    def wait_all(self, timeout=60.0):
        deadline = time.time() + timeout
        for q in self.queries.values():
            q.event.wait(max(0.0, deadline - time.time()))
        return all(q.event.is_set() for q in self.queries.values())

    def shutdown(self):
        """Idempotent teardown: cancel armed SLO timers, wake every worker
        with a shutdown sentinel (blocking ``get`` — no poll loop to time
        out), flush the partial trailing coding group."""
        with self.lock:
            already = self._shutdown
            self._shutdown = True
            timers, self._timers = self._timers, set()
        for t in timers:
            t.cancel()
        if not already:
            for w in self.workers:
                w.stop = True
            for w in self.workers:
                # one sentinel per worker on its own queue: a worker blocked
                # in get() wakes instantly; a busy one exits after its item
                w.pool_q.put(_SHUTDOWN)
        for w in self.workers:
            w.join(timeout=5.0)
        # account abandoned queue backlog through the same tombstone rule a
        # worker applies at dequeue: a redundant item left behind (its query
        # already answered, or its parity group fully done) counts as
        # cancelled — exactly what the DES reports, where every queued item
        # is eventually popped.  Non-redundant leftovers stay uncounted.
        seen = set()
        for w in self.workers:
            if id(w.pool_q) in seen:
                continue
            seen.add(id(w.pool_q))
            while True:
                try:
                    item = w.pool_q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SHUTDOWN:
                    self._should_skip(item[0], item[1])
        # a workload that isn't a multiple of k leaves a partial coding group
        # behind; fulfill its members so wait_all() can't hang on them
        with self.lock:
            leftovers = list(self._pending_group)
            self._pending_group.clear()
        for qid in leftovers:
            q = self.queries.get(qid)
            if q is not None and not q.event.is_set():
                q.fulfill(self.default_prediction, "flushed")
        if self._controller is not None and not already:
            # drain the window clock out to the last submit — the DES
            # closes the same set (every window whose start precedes the
            # end of arrivals), so the decision sequences stay comparable
            while self._close_window():
                pass

    def stats(self) -> ServingReport:
        """Typed ``ServingReport`` (dict-compatible) with the same fields the
        DES (``repro_torch.serving.simulator.simulate``) reports. Queries flushed
        at shutdown appear in ``completed_by`` but are excluded from the
        latency numbers — their finish time is a shutdown artifact."""
        with self.lock:
            queries = list(self.queries.values())
            cq, cp = self.cancelled_queries, self.cancelled_parities
            nb, nbq = self._n_batches, self._n_batch_queries
            cd, cc = self.corrupted_detected, self.corrupted_corrected
            adjustments = tuple(self._adjust_log)
            windows, ps = self._window_idx, self.parity_served
        lats = np.array([q.latency_ms for q in queries
                         if q.event.is_set() and q.completed_by != "flushed"])
        by = {}
        for q in queries:
            if q.completed_by:
                by[q.completed_by] = by.get(q.completed_by, 0) + 1

        def pct(p):
            return float(np.percentile(lats, p)) if len(lats) else float("nan")

        return ServingReport(
            engine="threads",
            strategy=self.strategy.name,
            scheme=self.scheme.name if self.strategy.coded else None,
            scenario=self.scenario.name if self.scenario else None,
            n=int(len(lats)),
            median_ms=pct(50),
            p99_ms=pct(99),
            p999_ms=pct(99.9),
            mean_ms=float(lats.mean()) if len(lats) else float("nan"),
            max_ms=float(lats.max()) if len(lats) else float("nan"),
            completed_by=by,
            reconstructions=by.get("parity", 0),
            cancelled_queries=cq,
            cancelled_parities=cp,
            batches=nb,
            mean_batch_size=(nbq / nb) if nb else 1.0,
            corrupted_detected=cd,
            corrected=cc,
            controller=self._controller.name if self._controller else None,
            windows=windows,
            adjustments=adjustments,
            parity_served=ps)
