"""Discrete-event simulator of the ParM serving cluster (paper §5).

Reproduces the paper's tail-latency methodology without EC2: Poisson query
arrivals, single-queue load balancing (optimal for mean response time, §5.1),
background *network-shuffle* load that transiently inflates the service time
of randomly chosen instance pairs (§5.1 "Background traffic"), and 100k-query
runs reporting median / p99 / p99.9.

Strategies are ``ResilienceStrategy`` objects from
``repro.serving.strategy`` — the SAME objects the threaded runtime consumes,
so the two serving layers cannot drift.  ``simulate(cfg, strategy)`` accepts
either an instance or a registered name (``parm``, ``equal_resources``,
``approx_backup``, ``replication``, ``default_slo``, ``none``); the strategy
owns pool layout (the paper's m + m/k apples-to-apples budget, §5.1), group
assembly and on-unavailability behavior, and a strategy registered from any
other file runs here untouched.

Codes are ``CodingScheme`` objects resolved through ``get_scheme`` — again
the same objects ``ParMFrontend`` serves.  For a coded strategy the DES runs
one parity pool per parity model (r pools, paper §3.5), assembles coding
groups of ``scheme.k`` queries (a ``fixes_k`` scheme — approx_backup — owns
its group size; ``cfg.k`` stays the redundancy budget that sizes the pools),
and reconstruction follows the scheme's own recoverability rule via the
shared ``recoverable_rows`` (MDS all-or-nothing for linear codes: up to r
concurrent unavailabilities per group; per-row replica arrival for
replication and approximate backups), with encode/decode latency scaled by
the scheme's ``encode_cost`` / ``decode_cost`` hints.  A scheme marked
``approximate`` (the approx_backup scheme) runs its parity pool at
``cfg.approx_speedup`` times the deployed service rate — the §5.2.6
cheap-backup economics, now scheme-owned instead of a dedicated backup-pool
special case.

Fault injection beyond the built-in shuffle load comes from ``Scenario``
objects (``repro.serving.scenarios``): ``simulate(cfg, strategy,
scenario="crash")`` realizes the scenario's hazards — instance crash/restart,
correlated pool slowdowns, bursty MMPP arrivals, heterogeneous service rates
— into per-server slowdown windows.  With ``scenario=None`` the legacy
cfg-driven shuffle process runs unchanged.  The ``byzantine`` hazard family
(``CorruptOutputs``) is a different fault class: responses computed inside a
corrupt window are *erroneous* rather than late.  For a ``detects_errors``
scheme (approxifer) the DES re-runs a joint vote whenever a response
touches a group: all corrupt responses the group holds are evicted
together once ``n_held >= k + 2 * n_candidates`` (the classical 2e-surplus
error-correction margin, the same one the frontend's numeric
``flag_errors`` enforces) — caught in time, the affected query is served
from a clean reconstruction; caught late, the garbage was already served
and only the detection is recorded.  Counts surface as
``ServingReport.corrupted_detected`` / ``corrected``.  Schemes without
detection accept the garbage silently, with identical latency.

This module is the **sim engine** behind the declarative serving surface in
``repro.serving.api``: ``deploy(spec, engine="sim").replay(trace)`` builds a
``SimConfig`` from (spec, trace) and calls ``simulate``.  Two serving-policy
behaviors mirror the threaded runtime exactly:

* **adaptive batching** (``cfg.batch_max_size > 1``): the main pool dequeues
  up to that many waiting queries per free server and charges one service
  interval on the calibrated per-batch curve
  ``service * (1 + batch_cost * (b - 1))`` with the *actual* batch size b —
  so tail-latency studies can sweep ``BatchingPolicy`` settings.  (The
  legacy ``cfg.batch_size`` static multiplier is unchanged for old studies.)
* **redundant-work cancellation**: queued originals whose query already
  completed (a parity decode beat them, a mirror replica won, the SLO
  default fired) and queued parity queries whose whole group already
  finished are tombstoned — skipped at dequeue without occupying a server —
  and counted in ``ServingReport.cancelled_queries`` /
  ``cancelled_parities``, matching the runtime's dequeue-time semantics.

Workload axis (DESIGN.md §11):

* **arrival processes** — a scenario hazard with an ``arrival_times`` hook
  replaces the Poisson default: MMPP bursts (``bursty``), sinusoidal
  day/night load (``diurnal``), exponentially-decaying rate spikes
  (``flash_crowd``), explicit timestamp replay (``TraceArrivals``).
  ``cfg.arrival_times_ms`` short-circuits all of that with a raw timestamp
  array.
* **multi-tenant mode** (``cfg.tenants``, a tuple of ``TenantClass``):
  arrivals are tagged with a tenant drawn from the classes' traffic shares;
  the main pool dequeues by weighted fair queueing over per-tenant queues
  (stride scheduling on virtual time — a tenant with weight 2 drains twice
  as fast under contention), per-class SLOs override ``cfg.slo_ms``, and
  ``ServingReport.per_tenant`` carries the per-class breakdown.

Performance: the event loop runs two ways.  Eligible configurations — no
controller, no tenants, no batching, mirror-free strategies, and a realized
``FaultPlan`` with no windows or rate skews (e.g. ``calm``, or any pure
arrival-process scenario) — take ``_fast_sim``, a fully inlined hot loop
over primitive-tuple heap entries and bytearray group state that sustains
millions of events per second (a seeded 10M-query ``sum``/r=1 run completes
in well under 30 s; ``BENCH_baseline.json`` locks the events/sec floor).
Everything else takes the general loop.  Both paths draw service times from
per-pool ``default_rng([seed, stream])`` child streams in pre-drawn blocks
and share dispatch order, so for an eligible config the two paths are
**bit-identical** — ``_FORCE_PATH = "general"`` pins that in tests.
``ServingReport.events`` counts processed events on either path.
"""
from __future__ import annotations

import gc
import heapq
import math
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.scheme import (ReplicationScheme, decode_cost,
                                     encode_cost, get_scheme,
                                     recoverable_rows, scheme_capabilities)
from repro_torch.serving.controller import Adjustment, get_controller
from repro_torch.serving.report import ServingReport, build_window
from repro_torch.serving.scenarios import TenantClass, get_scenario
from repro_torch.serving.strategy import get_strategy

# service-time draws come in pre-drawn blocks of this many per pool; one
# block refill replaces tens of thousands of per-event Generator calls
_CHUNK = 1 << 15

# test hook: None = auto (fast loop when eligible), "general" forces the
# general loop, "fast" asserts eligibility (raises if the config cannot
# take the fast path).  The bit-equality test runs both and compares.
_FORCE_PATH: Optional[str] = None

# test hook for the general loop's batch-decode drain: None/"batched" =
# gather every touched group's reconstruction plan first, then complete them
# (the DES twin of the frontend's one-launch multigroup decode — decode time
# is still charged PER GROUP via decode_cost, so the drains are bit-equal);
# "pergroup" = interleave plan and completion per group (the pre-fusion
# path).  The fused/unfused differential test runs both and asserts
# identical ServingReports.
_FORCE_DECODE: Optional[str] = None


@dataclass
class SimConfig:
    m: int = 12                     # deployed-model instances
    k: int = 2                      # coding-group size (redundancy 1/k)
    r: int = 1                      # parity models per group (paper §3.5);
                                    # schemes may fix their own (replication)
    qps: float = 270.0
    n_queries: int = 100_000
    service_ms: float = 25.0        # mean inference time (ResNet-18 on K80)
    service_cv: float = 0.05        # coefficient of variation (lognormal)
    # background load: concurrent network shuffles, each congesting the
    # link of one randomly chosen instance for its duration; queries served
    # by a congested instance incur an additional transfer delay
    n_shuffles: int = 4
    shuffle_ms: tuple = (300.0, 700.0)   # duration ~ U[a, b]
    shuffle_gap_ms: tuple = (800.0, 2400.0)  # idle gap between shuffles
    shuffle_delay_ms: tuple = (10.0, 40.0)   # added per-query delay when slow
    shuffle_slowdown: float = 1.0        # optional multiplicative part
    encode_ms: float = 0.153        # paper §5.2.5 (k=3 median), in ms
    decode_ms: float = 0.014        # one r=1 subtraction decode; multi-row
                                    # decodes pay scheme.decode_cost() times it
    approx_speedup: float = 1.15    # §5.2.6, GPU cluster value
    slo_ms: float = 200.0           # default-prediction deadline
                                    # (default_slo); None disables the
                                    # deadline, matching a threads-engine
                                    # deployment with no slo_ms set
    batch_size: int = 1             # §5.2.3 legacy static model: every
                                    # service interval is charged for a fixed
                                    # batch of this size
    batch_cost: float = 0.2         # service(b) = service * (1 + cost*(b-1));
                                    # GPUs batch well (paper scaled qps by the
                                    # observed throughput gain)
    batch_max_size: int = 1         # adaptive batching (BatchingPolicy
                                    # .max_size): main pool dequeues up to
                                    # this many queries per free server and
                                    # charges the per-batch curve at the
                                    # ACTUAL batch size
    seed: int = 0
    # multi-tenant mode: TenantClass tuple (or dicts of its fields) tagging
    # traffic with shares / WFQ weights / per-class SLOs; empty tuple =
    # single-tenant.  DESIGN.md §11
    tenants: tuple = ()
    # explicit arrival timestamps (ms), overriding both the Poisson default
    # and any scenario arrival process; must hold >= n_queries
    # non-decreasing times (TenantClass-style cycling of short traces is
    # TraceArrivals' job)
    arrival_times_ms: Optional[tuple] = None


def _as_tenant(tc) -> TenantClass:
    """Normalize a tenant entry: ``TenantClass`` passes through, a dict of
    its fields (a JSON config, or an ``asdict``-flattened trace) is
    rehydrated."""
    if isinstance(tc, TenantClass):
        return tc
    if isinstance(tc, dict):
        return TenantClass(**tc)
    raise TypeError(f"not a TenantClass or dict of its fields: {tc!r}")


class _Pool:
    """Single-queue pool of n servers with per-server slowdown windows.

    ``batch_max`` — adaptive batching: a free server takes up to this many
    queued items per dispatch (1 = no batching).  ``skip`` — redundant-work
    tombstone check applied at dequeue; skipped items never occupy a server.

    Service times are drawn from a dedicated ``default_rng([seed, stream])``
    child stream in pre-drawn blocks of ``_CHUNK`` (``draw``) — the parent
    generator is reserved for setup-time draws (arrivals, hazard
    realization, tenant assignment), which keeps seeded arrival patterns
    stable across simulator changes and lets the fast path share the exact
    draw sequence.

    ``use_wfq(weights)`` switches the queue to weighted fair queueing over
    per-tenant deques (stride scheduling: each dequeue advances the chosen
    tenant's virtual time by 1/weight; a tenant going from idle to busy
    catches its virtual time up to the pool's, so idle periods bank no
    credit).  Tombstoned items are charged like real ones — cancellation
    cost lands on the tenant that queued the work.
    """

    def __init__(self, name, n, stream, cfg, mean_ms, batch_max=1,
                 skip=None):
        self.name = name
        self.n = n
        self.free = list(range(n))
        self.queue = deque()
        self.rng = np.random.default_rng([cfg.seed, stream])
        self.cfg = cfg
        self.mean = mean_ms
        self.batch_max = batch_max
        self.skip = skip
        self.n_calls = 0                # inference calls (batches) served
        self.n_items = 0                # queries those calls carried
        self.slow_until = [0.0] * n
        self.plan = None                # FaultPlan from a Scenario, if any
        self._hazardous = False         # plan has windows/rates on THIS pool
        self._corruptible = False       # ... including corrupt windows
        self.sigma = math.sqrt(math.log(1 + cfg.service_cv ** 2))
        self.mu = math.log(mean_ms) - self.sigma ** 2 / 2
        self._blk = ()                  # pre-drawn lognormal block
        self._bi = _CHUNK               # read cursor (== len -> refill)
        # WFQ state (None until use_wfq)
        self._tq = None
        self._vt = None
        self._stride = None
        self._vnow = 0.0

    def set_plan(self, plan):
        """Attach a realized FaultPlan, pre-answering the two hot-path
        questions (any hazard here at all? any corrupt window?) so calm and
        narrowly-targeted scenarios skip the per-dispatch window lookup."""
        self.plan = plan
        self._hazardous = plan.relevant(self.name)
        self._corruptible = self._hazardous and plan.n_corrupt > 0

    def use_wfq(self, weights):
        self._tq = [deque() for _ in weights]
        self._vt = [0.0] * len(weights)
        self._stride = [1.0 / w for w in weights]

    def draw(self):
        """Next lognormal service draw off the pre-drawn block."""
        i = self._bi
        if i >= _CHUNK:
            self._blk = self.rng.lognormal(self.mu, self.sigma,
                                           _CHUNK).tolist()
            i = 0
        self._bi = i + 1
        return self._blk[i]

    def service_time(self, server, now, b=1):
        base = self.draw()
        # batching curve: adaptive batching charges the ACTUAL batch size;
        # the legacy static model charges cfg.batch_size for every interval
        eff_b = b if self.batch_max > 1 else self.cfg.batch_size
        if eff_b > 1:
            base *= 1.0 + self.cfg.batch_cost * (eff_b - 1)
        if now < self.slow_until[server]:
            base = base * self.cfg.shuffle_slowdown + \
                self.rng.uniform(*self.cfg.shuffle_delay_ms)
        if self._hazardous:
            base = self.plan.adjust_service_ms(self.name, server, now, base,
                                               self.rng)
        return base

    def corrupts(self, server, now) -> bool:
        return self._corruptible and self.plan.corrupts(self.name, server,
                                                        now)

    def submit(self, item, tenant=None):
        if self._tq is None:
            self.queue.append(item)
            return
        q = self._tq[tenant]
        if not q:
            # idle -> busy: catch the tenant's virtual time up to the
            # pool's, so idle periods bank no scheduling credit
            if self._vt[tenant] < self._vnow:
                self._vt[tenant] = self._vnow
        q.append(item)

    def _nonempty(self):
        if self._tq is None:
            return bool(self.queue)
        return any(self._tq)

    def _pop_next(self):
        if self._tq is None:
            return self.queue.popleft()
        best, bvt = -1, math.inf
        for i, q in enumerate(self._tq):
            if q and self._vt[i] < bvt:
                bvt = self._vt[i]
                best = i
        self._vnow = bvt
        self._vt[best] = bvt + self._stride[best]
        return self._tq[best].popleft()

    def try_dispatch(self, now):
        """Returns list of (server, items, finish_time); ``items`` is the
        batch one server serves in one inference call."""
        out = []
        while self.free and self._nonempty():
            batch = []
            while len(batch) < self.batch_max and self._nonempty():
                item = self._pop_next()
                if self.skip is not None and self.skip(item):
                    continue            # tombstoned while queued
                batch.append(item)
            if not batch:
                break                   # queue drained by tombstones
            s = self.free.pop()
            self.n_calls += 1
            self.n_items += len(batch)
            out.append((s, batch,
                        now + self.service_time(s, now, len(batch))))
        return out


def _finalize_report(cfg, strat, cur, scen, ctl, n_windows, adjust_log,
                     latency, how, cancelled_q, cancelled_p, main_calls,
                     main_items, parity_served, corrupted_detected,
                     corrected, n_events, tenant_of=None, classes=None):
    """Completeness check + ServingReport assembly shared by both loop
    implementations, so the two paths cannot drift in what they report."""
    n = cfg.n_queries
    finite = np.isfinite(latency)
    if int(finite.sum()) != n:
        # a hard error, not an assert: an event-handling bug that drops
        # queries must fail loudly even under ``python -O`` — percentiles
        # over a silently-shortened array are exactly the kind of wrong
        # answer a capacity-planning instrument must never produce
        missing = np.nonzero(~finite)[0]
        head = ", ".join(str(int(q)) for q in missing[:10])
        more = ", ..." if missing.size > 10 else ""
        raise RuntimeError(
            f"simulator dropped {missing.size} of {n} queries "
            f"(unanswered qids: {head}{more}) — every query must complete "
            f"by model, parity reconstruction, or SLO default")
    lat = latency
    how = np.asarray(how, dtype=np.int8)
    per_tenant = {}
    if classes:
        for ti, tc in enumerate(classes):
            mask = tenant_of == ti
            cnt = int(mask.sum())
            lt = lat[mask]
            eff = tc.slo_ms if tc.slo_ms is not None else cfg.slo_ms
            # a default-served query finishes AT the deadline (latency ==
            # slo, not >), but it was answered with the default prediction
            # — that is a violation, so count how==2 explicitly
            if eff is not None:
                viol = int(((lt > eff) | (how[mask] == 2)).sum())
            else:
                viol = int((how[mask] == 2).sum())
            per_tenant[tc.name] = {
                "n": cnt,
                "share": cnt / n if n else 0.0,
                "median_ms": float(np.percentile(lt, 50)) if cnt
                else float("nan"),
                "p999_ms": float(np.percentile(lt, 99.9)) if cnt
                else float("nan"),
                "slo_ms": eff,
                "slo_violations": viol,
            }
    by = {}
    for code, name in ((0, "model"), (1, "parity"), (2, "default")):
        c = int((how == code).sum())
        if c:
            by[name] = c
    return ServingReport(
        engine="sim",
        strategy=strat.name,
        # the report names the scheme the run ENDED on (post-adjustments)
        scheme=cur["schm"].name if strat.coded else None,
        scenario=scen.name if scen is not None else None,
        n=n,
        median_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        p999_ms=float(np.percentile(lat, 99.9)),
        mean_ms=float(lat.mean()),
        max_ms=float(lat.max()),
        completed_by=by,
        reconstructions=int((how == 1).sum()),
        cancelled_queries=cancelled_q,
        cancelled_parities=cancelled_p,
        batches=main_calls,
        mean_batch_size=(main_items / main_calls) if main_calls else 1.0,
        corrupted_detected=corrupted_detected,
        corrected=corrected,
        controller=ctl.name if ctl is not None else None,
        windows=n_windows,
        adjustments=tuple(adjust_log),
        parity_served=parity_served,
        events=n_events,
        per_tenant=per_tenant)


def _fast_sim(cfg, strat, cur, pred, pools, arrivals, scen):
    """The inlined hot loop for eligible configurations.

    Preconditions (checked by ``simulate``): no controller, no tenants, no
    adaptive batching, ``strat.mirror == 1``, no SLO defaults, a realized
    ``FaultPlan`` with zero windows and no rate skews, and — for coded
    strategies — a scheme whose recoverability rule is one of the three
    closed forms (``mds`` all-or-nothing, ``row`` per-replica,
    ``count`` dynamic-arity).

    Bit-identical to the general loop on these configs: same per-pool child
    RNG streams read through the same ``_CHUNK``-block discipline, same
    dispatch order, same float arithmetic.  All state lives in locals —
    primitive-tuple heap entries ``(finish_t, seq, pool_code, item)``,
    bytearray group counters, list-backed queues — which is what buys the
    order-of-magnitude over the object-per-event general loop.

    The cyclic GC is paused for the duration (restored on exit): the loop
    allocates tens of millions of short-lived tuples but no cycles, and in
    a process with a large live graph (the bench suite imports jax) each
    generational scan over it costs real wall time.
    """
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _fast_sim_inner(cfg, strat, cur, pred, pools, arrivals, scen)
    finally:
        if gc_was_enabled:
            gc.enable()


def _fast_sim_inner(cfg, strat, cur, pred, pools, arrivals, scen):
    n = cfg.n_queries
    arr = arrivals.tolist()
    INF = float("inf")
    coded = strat.coded
    gk, r = cur["gk"], cur["r"]
    enc, dec = cur["enc_ms"], cfg.decode_ms
    schm = cur["schm"]
    bmul = 1.0 + cfg.batch_cost * (cfg.batch_size - 1)
    scaled = cfg.batch_size > 1

    CHUNK = _CHUNK                  # local alias for the hot refill checks

    main = pools["main"]
    mrng, mmu, msig = main.rng, main.mu, main.sigma
    mblk = mrng.lognormal(mmu, msig, CHUNK).tolist()
    mbi = 0
    mfree = main.n
    mq = deque()
    mq_append, mq_popleft = mq.append, mq.popleft

    # r1/is_mds defaults keep the uncoded loop's branch tests well-defined
    r1 = is_mds = is_row = False
    full_g = 0
    if coded:
        pp = [pools[f"parity{j}"] for j in range(r)]
        prngs = [p.rng for p in pp]
        pmus = [p.mu for p in pp]
        psigs = [p.sigma for p in pp]
        pblk = [prngs[j].lognormal(pmus[j], psigs[j], CHUNK).tolist()
                for j in range(r)]
        pbi = [0] * r
        pfree = [p.n for p in pp]
        pqs = [deque() for _ in pp]
        full_g = n // gk
        g_resp = bytearray(full_g + 1)
        g_done = bytearray(full_g + 1)
        g_par = bytearray(full_g + 1)
        g_pmask = [0] * (full_g + 1)            # row-predicate parity mask
        dct = [float(decode_cost(schm, i)) for i in range(gk + 1)]
        kneed = schm.k if pred == "count" else 0
        gk1 = gk - 1
        is_mds = pred == "mds"
        is_row = pred == "row"
        # r == 1 (the benchmark case, and every built-in coded strategy's
        # default) gets scalar parity locals — one server-count int, one
        # service block, one queue — instead of per-j list indexing
        r1 = r == 1
        if r1:
            prng0, pmu0, psig0 = prngs[0], pmus[0], psigs[0]
            pblk0 = pblk[0]
            pbi0 = 0
            pfree0 = pfree[0]
            pq0 = pqs[0]
            pq0_append, pq0_popleft = pq0.append, pq0.popleft

    done = bytearray(n)
    member_resp = bytearray(n)
    done_t = [0.0] * n
    how = bytearray(n)
    cancelled_q = cancelled_p = 0

    heap = []
    push, pop = heapq.heappush, heapq.heappop
    seq = n            # runtime events; arrivals own virtual seqs 0..n-1
    ai = 0
    next_arr = arr[0] if n else INF

    while True:
        if heap:
            take_arr = ai < n and next_arr <= heap[0][0]
        elif ai < n:
            take_arr = True
        else:
            break
        if take_arr:
            qi = ai
            t = next_arr
            ai += 1
            next_arr = arr[ai] if ai < n else INF
            # invariant: a free server implies an empty queue (every finish
            # drains tombstones until it dispatches or idles), so a direct
            # dispatch here matches the general submit-then-try_dispatch
            if mfree:
                mfree -= 1
                if mbi == CHUNK:
                    mblk = mrng.lognormal(mmu, msig, CHUNK).tolist()
                    mbi = 0
                svc = mblk[mbi]
                mbi += 1
                if scaled:
                    svc *= bmul
                push(heap, (t + svc, seq, 0, qi))
                seq += 1
            else:
                mq_append(qi)
            if coded and qi % gk == gk1:
                # group boundary: encode + dispatch r parity queries.  The
                # gk-th member just arrived, so the group cannot be fully
                # done — no tombstone check on this direct dispatch
                g = qi // gk
                if r1:
                    if pfree0:
                        pfree0 -= 1
                        if pbi0 == CHUNK:
                            pblk0 = prng0.lognormal(
                                pmu0, psig0, CHUNK).tolist()
                            pbi0 = 0
                        svc = pblk0[pbi0]
                        pbi0 += 1
                        if scaled:
                            svc *= bmul
                        push(heap, (t + enc + svc, seq, 1, g))
                        seq += 1
                    else:
                        pq0_append(g)
                else:
                    tenc = t + enc
                    for j in range(r):
                        if pfree[j]:
                            pfree[j] -= 1
                            bi = pbi[j]
                            if bi == CHUNK:
                                pblk[j] = prngs[j].lognormal(
                                    pmus[j], psigs[j], CHUNK).tolist()
                                bi = 0
                            svc = pblk[j][bi]
                            pbi[j] = bi + 1
                            if scaled:
                                svc *= bmul
                            push(heap, (tenc + svc, seq, j + 1, g))
                            seq += 1
                        else:
                            pqs[j].append(g)
            continue
        ev = pop(heap)
        t = ev[0]
        code = ev[2]
        if code == 0:                           # main-pool finish
            qi = ev[3]
            if coded:
                member_resp[qi] = 1
                g = qi // gk
                g_resp[g] += 1
                if not done[qi]:
                    done[qi] = 1
                    done_t[qi] = t
                    g_done[g] += 1
                if g_par[g] and g_done[g] < gk:
                    # mds (the default predicate) is inlined: on the 10M
                    # benchmark the call overhead of _fast_recon alone is
                    # seconds of wall time
                    if is_mds:
                        missing = gk - g_resp[g]
                        if missing and g_par[g] >= missing:
                            ready = t + dec * dct[missing]
                            base = g * gk
                            for i2 in range(base, base + gk):
                                if not member_resp[i2] and not done[i2]:
                                    done[i2] = 1
                                    aq = arr[i2]
                                    done_t[i2] = (ready if ready > aq
                                                  else aq)
                                    how[i2] = 1
                                    g_done[g] += 1
                    else:
                        _fast_recon(pred, g, gk, t, dec, dct, kneed,
                                    g_resp, g_done, g_par, g_pmask,
                                    member_resp, done, done_t, how, arr)
            elif not done[qi]:
                done[qi] = 1
                done_t[qi] = t
            while mq:
                nqi = mq_popleft()
                if done[nqi]:
                    cancelled_q += 1
                    continue
                if mbi == CHUNK:
                    mblk = mrng.lognormal(mmu, msig, CHUNK).tolist()
                    mbi = 0
                svc = mblk[mbi]
                mbi += 1
                if scaled:
                    svc *= bmul
                push(heap, (t + svc, seq, 0, nqi))
                seq += 1
                break
            else:
                mfree += 1
        elif r1:                                # parity finish, scalar path
            g = ev[3]
            g_par[g] += 1
            if is_row:
                g_pmask[g] |= 1
            if g_done[g] < gk:
                if is_mds:
                    missing = gk - g_resp[g]
                    if missing and g_par[g] >= missing:
                        ready = t + dec * dct[missing]
                        base = g * gk
                        for i2 in range(base, base + gk):
                            if not member_resp[i2] and not done[i2]:
                                done[i2] = 1
                                aq = arr[i2]
                                done_t[i2] = ready if ready > aq else aq
                                how[i2] = 1
                                g_done[g] += 1
                else:
                    _fast_recon(pred, g, gk, t, dec, dct, kneed, g_resp,
                                g_done, g_par, g_pmask, member_resp, done,
                                done_t, how, arr)
            while pq0:
                ng = pq0_popleft()
                if g_done[ng] >= gk:
                    cancelled_p += 1
                    continue
                if pbi0 == CHUNK:
                    pblk0 = prng0.lognormal(pmu0, psig0, CHUNK).tolist()
                    pbi0 = 0
                svc = pblk0[pbi0]
                pbi0 += 1
                if scaled:
                    svc *= bmul
                push(heap, (t + svc, seq, 1, ng))
                seq += 1
                break
            else:
                pfree0 += 1
        else:                                   # parity-pool finish, r > 1
            j = code - 1
            g = ev[3]
            g_par[g] += 1
            g_pmask[g] |= 1 << j
            if g_done[g] < gk:
                _fast_recon(pred, g, gk, t, dec, dct, kneed, g_resp,
                            g_done, g_par, g_pmask, member_resp, done,
                            done_t, how, arr)
            q = pqs[j]
            while q:
                ng = q.popleft()
                if g_done[ng] >= gk:
                    cancelled_p += 1
                    continue
                bi = pbi[j]
                if bi == CHUNK:
                    pblk[j] = prngs[j].lognormal(
                        pmus[j], psigs[j], CHUNK).tolist()
                    bi = 0
                svc = pblk[j][bi]
                pbi[j] = bi + 1
                if scaled:
                    svc *= bmul
                push(heap, (t + svc, seq, j + 1, ng))
                seq += 1
                break
            else:
                pfree[j] += 1

    done_arr = np.frombuffer(bytes(done), dtype=np.uint8).astype(bool)
    latency = np.where(done_arr, np.asarray(done_t) - arrivals, np.inf)
    # call/item counters are derived, not tracked per event: every query is
    # dequeued exactly once (dispatched or tombstone-cancelled), and every
    # assembled group enqueues exactly r parity items, so at drain-out
    # main calls = n - cancelled_q and parity items = full_g*r - cancelled_p
    main_calls = n - cancelled_q
    parity_served = full_g * r - cancelled_p if coded else 0
    # likewise events = arrivals + finish pops; no per-event increment needed
    n_ev = n + main_calls + parity_served
    return _finalize_report(
        cfg, strat, cur, scen, None, 0, (), latency,
        np.frombuffer(bytes(how), dtype=np.uint8), cancelled_q,
        cancelled_p, main_calls, main_calls, parity_served, 0, 0, n_ev)


def _fast_recon(pred, g, gk, t, dec, dct, kneed, g_resp, g_done, g_par,
                g_pmask, member_resp, done, done_t, how, arr):
    """Closed-form ``maybe_reconstruct`` for the three supported
    recoverability rules.  Caller guarantees ``g_par[g] > 0`` and
    ``g_done[g] < gk`` — which also keeps never-assembled trailing groups
    out (their g_par stays 0).  ``dct`` is indexed by the TOTAL number of
    rows the decode touches (resp-missing members, done or not), matching
    ``recoverable_rows(...).sum()`` in the general loop."""
    base = g * gk
    if pred == "row":
        mask = g_pmask[g]
        nrows = 0
        for i in range(gk):
            if not member_resp[base + i] and (mask >> i) & 1:
                nrows += 1
        if not nrows:
            return
        ready = t + dec * dct[nrows]
        for i in range(gk):
            qi = base + i
            if not member_resp[qi] and (mask >> i) & 1 and not done[qi]:
                done[qi] = 1
                aq = arr[qi]
                done_t[qi] = ready if ready > aq else aq
                how[qi] = 1
                g_done[g] += 1
        return
    missing = gk - g_resp[g]
    if not missing:
        return
    if pred == "mds":
        if g_par[g] < missing:
            return
    elif g_resp[g] + g_par[g] < kneed:           # pred == "count"
        return
    ready = t + dec * dct[missing]
    for i in range(base, base + gk):
        if not member_resp[i] and not done[i]:
            done[i] = 1
            aq = arr[i]
            done_t[i] = ready if ready > aq else aq
            how[i] = 1
            g_done[g] += 1


def simulate(cfg: SimConfig, strategy="parm", scheme=None, scenario=None,
             backend=None, controller=None, device="cuda"):
    """Run the DES under a ``ResilienceStrategy`` (instance or registered
    name).  ``scheme`` (instance or name) overrides the strategy's default
    code for coded strategies; ``scenario`` (instance or name) overrides the
    built-in shuffle background load with a hazard set from
    ``repro.serving.scenarios``.  ``backend`` is validated through the same
    ``get_scheme`` resolution the threads engine applies — the DES runs no
    kernel math, but an identical spec must pass or fail identically on both
    engines.  ``controller`` (instance or registered name from
    ``repro.serving.controller``) closes the loop: every
    ``controller.window_ms`` of simulated time a ``ctl`` event builds a
    ``ReportWindow`` from the completions inside the window and applies any
    returned ``Adjustment`` at the next coding-group boundary — on this
    clock, as events, so the differential battery can assert identical
    decision sequences against the threads engine.  Returns a
    ``ServingReport`` (typed, dict-compatible) with latency percentiles and
    bookkeeping.  ``device`` is where registry-name schemes (the
    deployment's and a controller's escalation target) are resolved, as
    every entry point of the port: ``"cuda"`` unless the caller asks for
    ``"cpu"``.  The DES itself runs no device work."""
    strat = get_strategy(strategy)
    rng = np.random.default_rng(cfg.seed)
    k = cfg.k                               # redundancy budget (pool sizing)
    parity_service_ms = cfg.service_ms
    # resolve the scheme UNCONDITIONALLY, exactly like ParMFrontend._build:
    # an invalid scheme/backend must fail identically on both engines even
    # under a non-coded strategy (which then simply never uses the code)
    want = scheme if scheme is not None else (strat.scheme or "sum")
    # cfg.r sizes registry-name schemes; an instance carries its own r
    # (mirrors ParMFrontend, which defaults r to the instance's value)
    resolved = get_scheme(want, k=k,
                          r=cfg.r if isinstance(want, str) else None,
                          backend=backend, device=device)
    # the CURRENT deployment knobs — mutable, because a controller may
    # retune them mid-run; new coding groups capture them at assembly
    cur = {"schm": None, "r": cfg.r, "gk": k, "enc_ms": cfg.encode_ms,
           "det": False, "batch_max": max(1, cfg.batch_max_size)}
    if strat.coded:
        caps = scheme_capabilities(resolved)
        cur["schm"] = resolved
        cur["r"] = resolved.r               # a scheme may fix its own r
        cur["gk"] = resolved.k              # ... and its own group size
        cur["enc_ms"] = cfg.encode_ms * encode_cost(resolved)
        # capability read hoisted out of the per-group hot loop
        cur["det"] = caps.detects_errors
        if caps.approximate:
            # approx_backup scheme: the parity pool runs cheap backup models
            parity_service_ms = cfg.service_ms / cfg.approx_speedup
    # the deployment's own resolved scheme OBJECT and r: controller
    # de-escalation restores this instance (not a fresh registry default
    # under the same name), and group dispatch routes by identity against
    # it — the same contract as ParMFrontend._base_scheme
    base_schm, base_r = cur["schm"], cur["r"]

    ctl = None
    if controller is not None:
        ctl = get_controller(controller)

    # multi-tenant mode (DESIGN.md §11): normalize classes, validate names
    classes = tuple(_as_tenant(tc) for tc in cfg.tenants)
    if classes:
        names = [tc.name for tc in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        slo_of = [tc.slo_ms if tc.slo_ms is not None else cfg.slo_ms
                  for tc in classes]

    n = cfg.n_queries
    latency = np.full(n, np.inf)
    done = np.zeros(n, bool)
    how = np.zeros(n, np.int8)              # 0 model | 1 parity | 2 default
    cancelled = {"q": 0, "p": 0}
    # Byzantine bookkeeping (detects_errors schemes under corrupt-output
    # hazards): responses voted out, and affected predictions served clean
    corrupted = {"detected": 0, "corrected": 0}
    member_resp = np.zeros(n, bool)         # member responses the decoder
                                            # currently holds (clean, or
                                            # corrupt but not yet voted out)
    corrupt_members = {}                    # gid -> set of qi: corrupt member
                                            # responses held, not yet evicted
    corrupt_parities = {}                   # gid -> set of j: likewise
    corrupt_stash = {}                      # qi -> finish_t: voted-out member
                                            # responses whose query is still
                                            # unanswered

    # dynamic coding-group bookkeeping (coded strategies only): groups
    # assemble from consecutive arrivals and CAPTURE the scheme / r / error
    # detection active at assembly, so a controller adjustment applies at
    # the next group boundary without touching in-flight groups — the same
    # contract the threaded frontend honors.  Member availability is read
    # off ``done`` — a reconstructed member counts as available for the
    # next decode decision, exactly as in the runtime's _maybe_decode
    groups = {}      # gid -> {"members", "schm", "r", "det", "parity_t"}
    gid_of = {}      # qi -> gid, assigned at arrival
    pending = []     # members of the group currently assembling
    next_gid = 0

    def tombstoned(item):
        """Dequeue-time redundant-work cancellation — the DES mirror of the
        runtime's ``ParMFrontend._should_skip``: an original whose query
        already completed, or a parity query whose whole group did, is
        skipped without occupying a server."""
        kind, idx = item
        if kind == "q":
            if done[idx]:
                cancelled["q"] += 1
                return True
            return False
        if done[groups[idx[0]]["members"]].all():
            cancelled["p"] += 1
            return True
        return False

    # A controller may escalate at runtime: parity pools come in TWO
    # families, mirroring ParMFrontend._build.  Pools 0..base_r-1 are the
    # deployment's own parity pools; Controller.escalation_r extra pools
    # model workers running the *deployed* parameters (plain service time,
    # never the approx-backup speedup), and every adjustment that is not an
    # exact return to the base dispatches there.
    agn_base, agn_r = cur["r"], 0
    if ctl is not None and strat.coded:
        esc = getattr(ctl, "escalation_r", ctl.max_r)
        agn_r = max(0, int(esc(cur["r"])))
    r_pools = cur["r"] + agn_r
    layout = strat.layout(cfg.m, k, cur["r"])
    # per-pool child RNG streams ([seed, 0] = main, [seed, 1 + j] = parity
    # pool j): service draws come off these in pre-drawn blocks, leaving
    # the parent generator to setup-time draws only
    pools = {"main": _Pool("main", layout.main, 0, cfg, cfg.service_ms,
                           batch_max=cur["batch_max"],
                           skip=tombstoned)}
    if layout.parity:
        for j in range(r_pools):
            svc = parity_service_ms if j < cur["r"] else cfg.service_ms
            pools[f"parity{j}"] = _Pool(f"parity{j}", layout.parity, 1 + j,
                                        cfg, svc,
                                        skip=tombstoned)
    if classes:
        pools["main"].use_wfq([tc.weight for tc in classes])

    # pre-draw arrivals (a scenario may replace Poisson with another
    # arrival process; cfg.arrival_times_ms overrides everything)
    scen = None
    if scenario is None:
        scenario = strat.scenario
    if scenario is not None:
        scen = get_scenario(scenario)
    arrivals = None
    if cfg.arrival_times_ms is not None:
        ats = np.asarray(cfg.arrival_times_ms, dtype=float)
        if ats.ndim != 1 or ats.size < n:
            raise ValueError(
                f"arrival_times_ms holds {ats.size} timestamps but "
                f"n_queries={n} (use TraceArrivals to cycle a short trace)")
        if ats.size > 1 and np.any(np.diff(ats[:n]) < 0):
            raise ValueError("arrival_times_ms must be non-decreasing")
        arrivals = ats[:n].copy()
    elif scen is not None:
        arrivals = scen.arrival_times(cfg, rng)
    if arrivals is None:
        arrivals = np.cumsum(rng.exponential(1000.0 / cfg.qps, n))
    arrival_t = arrivals.copy()
    end_of_arrivals = arrivals[-1]

    # tenant assignment draws follow the arrival draws on the parent
    # stream (single-tenant runs consume nothing here, so their seeded
    # arrival + hazard patterns are unchanged)
    tenant_of = None
    if classes:
        shares = np.asarray([tc.share for tc in classes], dtype=float)
        tenant_of = rng.choice(len(classes), size=n, p=shares / shares.sum())

    plan = None
    if scen is not None:
        # scenario-owned hazards: realize crash/slowdown/heterogeneity
        # windows over the arrival horizon; the legacy shuffle process is off
        plan = scen.realize({name: p.n for name, p in pools.items()},
                            end_of_arrivals, rng)
        for p in pools.values():
            p.set_plan(plan)

    # ------------------------------------------------------- path selection
    # the fast loop handles the no-feedback, no-tenant, unbatched,
    # mirror-free, hazard-free core — which includes every pure
    # arrival-process scenario — for schemes with a closed-form
    # recoverability rule; everything else takes the general loop below
    pred = None
    if not strat.coded:
        pred = "none"
    else:
        s_ = cur["schm"]
        if getattr(s_, "recoverable", None) is None:
            pred = "mds"
        elif getattr(type(s_), "recoverable", None) is \
                ReplicationScheme.recoverable and cur["r"] == cur["gk"]:
            pred = "row"
        elif type(s_).__name__ == "ApproxIFERScheme":
            pred = "count"
    have_parity = (not strat.coded or
                   all(f"parity{j}" in pools for j in range(cur["r"])))
    fast_ok = (n > 0 and ctl is None and not classes
               and strat.mirror == 1 and not strat.slo_default
               and cur["batch_max"] == 1 and pred is not None
               and have_parity and plan is not None
               and plan.n_windows == 0 and not plan.rates)
    if _FORCE_PATH == "general":
        fast_ok = False
    elif _FORCE_PATH == "fast" and not fast_ok:
        raise ValueError(
            "_FORCE_PATH='fast' but the config is not eligible for the "
            "fast DES path")
    if fast_ok:
        return _fast_sim(cfg, strat, cur, pred, pools, arrivals, scen)

    # ------------------------------------------------------- general loop
    events = []

    # closed-loop machinery: one "ctl" event per observation window whose
    # START precedes the end of arrivals (the threads engine closes the
    # same set: at submit time, plus trailing windows at shutdown).  Ctl
    # events own seqs 0..n_windows-1 so a ctl event at time t sorts ahead
    # of an arrival at the same t — the frontend ticks its window clock at
    # the top of submit(), before recording the query
    adjust_log = []          # (window_index, scheme, r, batch_max_size)
    wrecs = []               # (t_done, latency, by), kept sorted by t_done
    wprev = {"detected": 0, "cancel": 0}    # counter snapshots per window
    pending_adj = None       # (Adjustment, window_index) deferred to the
                             # next group boundary
    n_windows = 0
    ctl_state = None
    wlen = 0.0
    if ctl is not None:
        wlen = float(ctl.window_ms)
        n_windows = int(math.ceil(end_of_arrivals / wlen))
        for i in range(n_windows):
            heapq.heappush(events, ((i + 1) * wlen, i, "ctl", i))
        ctl_state = ctl.init(Adjustment(
            scheme=cur["schm"].name if strat.coded else None,
            r=cur["r"] if strat.coded else None,
            batch_max_size=cur["batch_max"]))

    # arrivals are NOT heap-resident: the loop merges the sorted arrival
    # array with the heap, comparing (t, seq) with virtual arrival seqs
    # n_windows..n_windows+n-1 — runtime-pushed events start past them, so
    # at equal t the order is ctl < arrival < finish/slo/shuffle, exactly
    # the order the old push-everything loop produced
    seq = n_windows + n

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, payload))
        seq += 1

    def apply_adjustment(adj, widx, live=True):
        """Retune the CURRENT knobs; in-flight groups keep what they
        captured.  Scheme/r apply only to coded strategies; batching to
        any.  The adjustment log records the post-adjustment knobs, and the
        threads engine records the identical tuples — the differential
        battery compares them verbatim.  ``live=False`` marks a trailing
        window (past the last arrival): record the decision and the final
        knobs but leave the serving pools alone — the threads engine only
        closes trailing windows at shutdown, after its workers have
        joined, so a trailing adjustment there can no longer batch or
        serve anything either."""
        if strat.coded and (adj.scheme is not None or adj.r is not None):
            name = adj.scheme if adj.scheme is not None \
                else cur["schm"].name
            want_r = adj.r if adj.r is not None else cur["r"]
            if name == base_schm.name and want_r == base_r:
                # de-escalation: restore the deployment's own scheme
                # instance (never a fresh registry default under the same
                # name), re-enabling identity-routing to the trained pools
                new = base_schm
            else:
                new = get_scheme(name, k=k, r=want_r, backend=backend,
                                 device=device)
                if not scheme_capabilities(new).model_agnostic:
                    raise ValueError(
                        f"controller adjustment to scheme {name!r} "
                        f"(r={new.r}) is not the deployment base and not "
                        f"model_agnostic — runtime escalation can only "
                        f"target schemes whose parity pool runs the "
                        f"deployed parameters")
                if new.r > agn_r:
                    raise ValueError(
                        f"controller adjustment needs r={new.r} "
                        f"escalation pools but only {agn_r} were "
                        f"provisioned — raise Controller.escalation_r")
            cur["schm"], cur["r"], cur["gk"] = new, new.r, new.k
            cur["enc_ms"] = cfg.encode_ms * encode_cost(new)
            cur["det"] = scheme_capabilities(new).detects_errors
        if adj.batch_max_size is not None:
            cur["batch_max"] = max(1, adj.batch_max_size)
            if live:
                pools["main"].batch_max = cur["batch_max"]
        adjust_log.append((widx,
                           cur["schm"].name if strat.coded else None,
                           cur["r"] if strat.coded else None,
                           cur["batch_max"]))

    if scen is None:
        # legacy background shuffles: a recurring process that slows random
        # instances, driven by the cfg.shuffle_* fields
        all_pools = list(pools.values())

        def schedule_shuffle(t0):
            if t0 > end_of_arrivals:      # stop background load after arrivals
                return
            dur = rng.uniform(*cfg.shuffle_ms)
            pool = all_pools[rng.integers(len(all_pools))]
            srv = rng.integers(pool.n)
            pool.slow_until[srv] = max(pool.slow_until[srv], t0 + dur)
            # next shuffle of this "tenant" after an idle gap
            push(t0 + dur + rng.uniform(*cfg.shuffle_gap_ms), "shuffle", None)

        for j in range(cfg.n_shuffles):
            schedule_shuffle(rng.uniform(0, 50.0))

    def dispatch(pool_name, now):
        pool = pools[pool_name]
        for s, items, fin in pool.try_dispatch(now):
            push(fin, "finish", (pool_name, s, items))

    def complete(qi, t, by=0):
        if not done[qi]:
            done[qi] = True
            latency[qi] = t - arrival_t[qi]
            how[qi] = by
            if ctl is not None:
                # ordered insert: completions are near-sorted (only a
                # future-dated decode can land behind later records, by at
                # most its decode latency), so the right-end bubble is a
                # few swaps at worst and window close below is one scan —
                # not the two full rebuilds per ctl event it used to be
                rec = (t, latency[qi], by)
                wrecs.append(rec)
                i = len(wrecs) - 1
                while i and wrecs[i - 1][0] > t:
                    wrecs[i] = wrecs[i - 1]
                    i -= 1
                wrecs[i] = rec

    def revote(g, t):
        """Joint Byzantine vote over group ``g``'s held responses — the DES
        mirror of ``ParMFrontend._screen``'s ``flag_errors`` call, re-run
        whenever a response touches the group (the frontend re-votes on
        every recorded arrival too, so an erroneous response accepted
        early, below the margin, is still caught once later responses
        provide the surplus).  All corrupt responses currently held are
        candidates together, evicted iff

            n_held  >=  k + 2 * n_candidates

        (``n_held`` counts every response the decoder holds, candidates
        included) — exactly the smallest-consistent-subset margin
        ``flag_errors`` enforces, including its abstention when two
        corruptions face only two surplus responses.  An evicted member
        already answered from a clean reconstruction counts corrected;
        one that answered its own query with the garbage is detected too
        late to help; one still unanswered stays missing for
        ``maybe_reconstruct`` (stashed so the end-of-run drain can serve
        the suspect output if no clean decode ever lands)."""
        cm = corrupt_members.get(g, ())
        cp = corrupt_parities.get(g, ())
        n_cand = len(cm) + len(cp)
        if not n_cand:
            return
        info = groups.get(g)
        if info is None:
            return      # group not assembled yet: no surplus can exist
        mem = info["members"]
        n_held = int(member_resp[mem].sum()) + \
            int(np.isfinite(info["parity_t"]).sum())
        if n_held < len(mem) + 2 * n_cand:
            return
        corrupted["detected"] += n_cand
        for qi in cm:
            member_resp[qi] = False
            if done[qi]:
                if how[qi] == 1:
                    corrupted["corrected"] += 1
            else:
                corrupt_stash[qi] = t
        for j in cp:
            info["parity_t"][j] = np.inf
        corrupt_members.pop(g, None)
        corrupt_parities.pop(g, None)

    def reconstruct_plan(g):
        """Reconstruction decision for one group: the shared
        ``recoverable_rows`` rule over (members whose response the decoder
        does not hold, parities arrived) — the exact decision
        ``ParMFrontend._decode_plan`` takes (its miss rule is "no
        trustworthy response recorded", NOT "query unanswered": an SLO- or
        eviction-answered member without a held response has no data to
        decode with), so the two layers agree by construction.  Returns
        ``(info, rows)`` or None."""
        info = groups.get(g)
        if info is None:
            return None     # never-assembled (partial trailing) group: the
                            # runtime never encodes one, so no decode here
        mem = info["members"]
        miss = ~member_resp[mem]
        if not miss.any() or done[mem].all():
            return None
        parity_avail = np.isfinite(info["parity_t"])
        if not parity_avail.any():
            return None
        rows = recoverable_rows(info["schm"], miss, parity_avail)
        if not rows.any():
            return None
        return info, rows

    def apply_reconstruction(info, rows, t):
        """Complete every recoverable member of one planned group.  Decode
        time is charged per group through the scheme's ``decode_cost`` hint
        whether the group decodes alone or inside a batched drain — the
        multigroup kernel's win is a LAUNCH-count win, which the timing
        model does not resolve, so batched and per-group drains stay
        bit-equal."""
        ready = t + cfg.decode_ms * decode_cost(info["schm"],
                                                int(rows.sum()))
        mem = info["members"]
        for j in np.nonzero(rows)[0]:
            qi = int(mem[int(j)])
            complete(qi, max(ready, arrival_t[qi]), by=1)
            if info["det"] and qi in corrupt_stash:
                # a member whose own response was voted out as corrupted,
                # now served from a clean reconstruction instead
                corrupted["corrected"] += 1
                corrupt_stash.pop(qi)

    def maybe_reconstruct(g, t):
        """Single-group reconstruction (plan + apply in one step)."""
        plan = reconstruct_plan(g)
        if plan is not None:
            apply_reconstruction(plan[0], plan[1], t)

    def reconstruct_groups(gids, t):
        """Batch-decode drain: every group a finish event touched, decoded
        together.  Gathers ALL groups' stacked reconstruction plans first —
        the DES twin of the frontend's one-launch ``decode_one_many`` /
        ``decode_many`` drain — then completes each at its own
        ``decode_cost`` charge.  Groups are disjoint (a query belongs to one
        group), so gather-then-apply completes exactly what interleaved
        per-group calls would: ``_FORCE_DECODE="pergroup"`` pins that in the
        differential test."""
        if _FORCE_DECODE == "pergroup":
            for g in gids:
                maybe_reconstruct(g, t)
            return
        plans = [p for p in (reconstruct_plan(g) for g in gids)
                 if p is not None]
        for info, rows in plans:
            apply_reconstruction(info, rows, t)

    arr_list = arrivals.tolist()
    ai = 0
    INF = float("inf")
    next_arr = arr_list[0] if n else INF
    n_ev = 0
    while True:
        if events:
            h0 = events[0]
            take_arr = ai < n and (
                next_arr < h0[0]
                or (next_arr == h0[0] and n_windows + ai < h0[1]))
        elif ai < n:
            take_arr = True
        else:
            break
        n_ev += 1
        if take_arr:
            t = next_arr
            qi = ai
            ai += 1
            next_arr = arr_list[ai] if ai < n else INF
            tn = int(tenant_of[qi]) if classes else None
            for _ in range(strat.mirror):
                pools["main"].submit(("q", qi), tenant=tn)
            dispatch("main", t)
            if strat.coded:
                gid_of[qi] = next_gid
                pending.append(qi)
                if len(pending) == cur["gk"]:
                    # group complete -> capture the current knobs, encode +
                    # dispatch r parity queries, one per parity model
                    # (§3.5); encoding happens on the frontend, so model
                    # its cost (scheme-owned: free for identity "encodes")
                    # as added latency on each parity path
                    g = next_gid
                    next_gid += 1
                    groups[g] = {
                        "members": np.array(pending, dtype=int),
                        "schm": cur["schm"], "r": cur["r"],
                        "det": cur["det"],
                        "parity_t": np.full(cur["r"], np.inf)}
                    pending.clear()
                    # base-scheme groups go to the trained parity pools;
                    # escalated groups to the deployed-params escalation
                    # pools at offset agn_base (ParMFrontend routes by the
                    # same identity test)
                    ofs = 0 if cur["schm"] is base_schm else agn_base
                    for j in range(cur["r"]):
                        pools[f"parity{ofs + j}"].submit(("p", (g, j)))
                        dispatch(f"parity{ofs + j}", t + cur["enc_ms"])
                    if pending_adj is not None:
                        # a deferred adjustment lands exactly at this group
                        # boundary — the frontend's contract
                        adj, widx = pending_adj
                        pending_adj = None
                        apply_adjustment(adj, widx)
            if strat.slo_default:
                # Clipper baseline deadline; per-tenant classes may
                # tighten or loosen it relative to cfg.slo_ms
                deadline = slo_of[tn] if classes else cfg.slo_ms
                if deadline is not None:
                    push(t + deadline, "slo", qi)
            continue
        ev = heapq.heappop(events)
        t = ev[0]
        kind = ev[2]
        if kind == "finish":
            pool_name, s, items = ev[3]
            pool = pools[pool_name]
            pool.free.append(s)
            # Byzantine injection: responses computed inside a corrupt
            # window are erroneous (one flag per inference call — the
            # threaded runtime corrupts per call too)
            corrupt = pool.corrupts(s, t)
            # complete EVERY item of the batch before any reconstruction
            # decision — mirroring the runtime's batch-atomic completion: a
            # decode must never treat a batch-mate as missing when its exact
            # output arrived in the same inference call.  Corrupt member
            # responses (detecting scheme) defer completion until after the
            # vote: an immediately-evicted one must not answer its query
            # with garbage
            touched = []
            deferred = []
            for ikind, idx in items:
                if ikind == "q":
                    # detection follows the scheme the item's GROUP
                    # captured (a member finishing before its group
                    # assembles screens under the knobs it will assemble
                    # with — the current ones)
                    if strat.coded:
                        g = int(gid_of[idx])
                        ginfo = groups.get(g)
                        det = ginfo["det"] if ginfo is not None else \
                            cur["det"]
                    else:
                        det = False
                    if corrupt and det:
                        member_resp[idx] = True
                        corrupt_members.setdefault(g, set()).add(idx)
                        deferred.append(idx)
                        touched.append(g)
                        continue
                    complete(idx, t)
                    if strat.coded:
                        member_resp[idx] = True
                        touched.append(g)
                else:  # parity output (g, j)
                    g, j = idx
                    ginfo = groups[g]
                    ginfo["parity_t"][j] = min(ginfo["parity_t"][j], t)
                    if corrupt and ginfo["det"]:
                        corrupt_parities.setdefault(
                            int(g), set()).add(int(j))
                    touched.append(int(g))
            for g in dict.fromkeys(touched):
                revote(g, t)
            for qi in deferred:
                if not done[qi] and qi not in corrupt_stash:
                    # the vote abstained (no surplus yet): the garbage is
                    # accepted and served as if clean — silently wrong,
                    # exactly what a non-detecting scheme always does
                    complete(qi, t)
            reconstruct_groups(dict.fromkeys(touched), t)
            dispatch(pool_name, t)
        elif kind == "slo":
            # Clipper baseline: answer with the default prediction at the
            # SLO deadline if the real prediction hasn't arrived
            complete(ev[3], t, by=2)
        elif kind == "shuffle":
            schedule_shuffle(t)
        else:  # "ctl"
            # close observation window [t - wlen, t): completions are
            # bucketed by their completion TIMESTAMP (a decode recorded
            # just before the boundary may complete just after it — that
            # record belongs to the next window), counters by per-window
            # delta.  wrecs is kept sorted by completion time, so the
            # window's records are a prefix — one scan, not two rebuilds.
            # Adjustments apply immediately when no group is assembling,
            # else at the next group boundary
            widx = ev[3]
            cut = 0
            nrec = len(wrecs)
            while cut < nrec and wrecs[cut][0] < t:
                cut += 1
            take = wrecs[:cut]
            del wrecs[:cut]
            win = build_window(
                widx, t - wlen, t,
                [(lat, by == 1) for (_, lat, by) in take],
                corrupted_detected=corrupted["detected"]
                - wprev["detected"],
                cancellations=cancelled["q"] + cancelled["p"]
                - wprev["cancel"])
            wprev["detected"] = corrupted["detected"]
            wprev["cancel"] = cancelled["q"] + cancelled["p"]
            adj, ctl_state = ctl.observe(ctl_state, win)
            if adj is not None:
                # windows past the last arrival are trailing: the threads
                # engine closes them at shutdown (workers joined, pending
                # group flushed), so the decision is recorded but applies
                # log-only — no pool may change mid-drain
                live = t <= end_of_arrivals
                if live and pending:
                    pending_adj = (adj, widx)
                else:
                    apply_adjustment(adj, widx, live=live)

    # detected-but-uncorrectable responses: the decoder knows they are
    # erroneous but never held enough clean responses to re-decode, so the
    # system serves the suspect output it received, at its actual finish
    # time — the same immediate-fulfillment choice the threaded frontend
    # makes when a flagged member is not recoverable
    for qi, tf in corrupt_stash.items():
        complete(qi, tf)

    main = pools["main"]
    return _finalize_report(
        cfg, strat, cur, scen, ctl, n_windows, adjust_log, latency, how,
        cancelled["q"], cancelled["p"], main.n_calls, main.n_items,
        sum(p.n_items for name, p in pools.items()
            if name.startswith("parity")),
        corrupted["detected"], corrupted["corrected"], n_ev,
        tenant_of=tenant_of, classes=classes)
