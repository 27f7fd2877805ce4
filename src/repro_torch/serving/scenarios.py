"""Injectable fault scenarios shared by BOTH serving layers.

A ``Scenario`` composes ``Hazard`` objects — instance crash/restart,
correlated whole-pool slowdowns, the paper's §5.1 background network
shuffles, bursty (Markov-modulated Poisson) arrivals, heterogeneous
per-server service rates — into one declarative object that

* the discrete-event simulator consumes natively
  (``simulate(cfg, strategy, scenario=...)`` realizes the hazards into a
  ``FaultPlan`` of per-pool/per-server slowdown windows), and
* the threaded runtime consumes through a fault-injecting ``delay_fn``
  adapter (``ParMFrontend(..., scenario=...)``), which maps worker instance
  ids onto the same (pool, server) coordinates and sleeps through the same
  windows in wall-clock time.

Because one object drives both layers, a hazard added here is immediately
runnable end-to-end through every registered (strategy x scheme) pair —
the same anti-drift contract the strategy/scheme registries provide
(DESIGN.md §6).

Scenarios are registered like schemes and strategies::

    register_scenario(Scenario("flaky", (InstanceCrash(), NetworkShuffles())))
    simulate(cfg, "parm", scenario="flaky")
    ParMFrontend(..., scenario="flaky")
    DeploymentSpec(..., scenario="flaky")      # either engine, via deploy()

Built-ins: ``calm``, ``shuffle``, ``crash``, ``correlated_slowdown``,
``bursty``, ``hetero``, ``byzantine`` (erroneous/corrupted responses —
the ``CorruptOutputs`` hazard family), ``storm`` (everything at once),
``diurnal`` (sinusoidal nonhomogeneous Poisson arrivals), ``flash_crowd``
(exponentially-decaying rate spikes).  Arrival processes can also replay
explicit timestamp traces (``TraceArrivals``), and ``TenantClass`` tags
traffic with per-tenant shares / WFQ weights / SLOs for the simulator's
multi-tenant mode (DESIGN.md §11).

The ``byzantine`` family is a different fault *class* from the rest: a
corrupt window does not (only) delay a response, it makes the response
**wrong**.  The DES flags such responses natively (``FaultPlan.corrupts``)
and lets a ``detects_errors`` coding scheme (approxifer) vote them out;
the threaded runtime injects real numerical corruption through the
``corrupt_fn`` adapter — the same window set the DES realizes — and the
frontend's decode path does the voting on actual outputs.  Corrupted
responses from the injector are garbage at ``CORRUPTION_SCALE``, matching
ApproxIFER's adversarial model (gross errors, not subtle bias).

All hazard times are in simulator milliseconds; the runtime adapter converts
them to wall-clock seconds via ``time_scale`` (1.0 = one sim-ms per real ms).
Multiplicative slowdowns apply only in the DES — the runtime runs real
inference, whose duration the adapter cannot scale, so it injects the
additive part (transfer delays, crash downtime) only.
"""
from __future__ import annotations

import random as _random
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# Worker instance-id convention shared with ``repro.serving.runtime``:
# main pool workers are 0..m-1, parity-queue j workers live at
# 1000 + 100*j + i, backup workers at 2000 + i.
MAIN_BASE = 0
PARITY_BASE = 1000
PARITY_STRIDE = 100
BACKUP_BASE = 2000

# What a Byzantine response is corrupted TO by the threaded runtime's fault
# injector: garbage at a scale far above any real model output, far above
# the approxifer decoder's voting tolerance (``err_tol``), so detection
# exercises the gross-error adversarial model rather than hinging on
# interpolation slack.
CORRUPTION_SCALE = 1.0e3


_MAX_PARITY_POOLS = (BACKUP_BASE - PARITY_BASE) // PARITY_STRIDE


def instance_id(pool: str, server: int) -> int:
    """(pool name, server index) -> the runtime's worker instance id.

    The encoding has finite ranges (main < 1000, parity pools of up to 100
    servers, at most 10 parity pools); out-of-range coordinates raise rather
    than silently collide with another pool's ids."""
    if pool == "main":
        if not 0 <= server < PARITY_BASE - MAIN_BASE:
            raise ValueError(f"main server index out of range: {server}")
        return MAIN_BASE + server
    if pool == "backup":
        if server < 0:
            raise ValueError(f"backup server index out of range: {server}")
        return BACKUP_BASE + server
    if pool.startswith("parity"):
        j = int(pool[len("parity"):] or 0)
        if not 0 <= j < _MAX_PARITY_POOLS:
            raise ValueError(
                f"at most {_MAX_PARITY_POOLS} parity pools encodable, "
                f"got pool {pool!r}")
        if not 0 <= server < PARITY_STRIDE:
            raise ValueError(
                f"at most {PARITY_STRIDE} servers per parity pool "
                f"encodable, got server {server}")
        return PARITY_BASE + PARITY_STRIDE * j + server
    raise ValueError(f"unknown pool {pool!r}")


def pool_of_iid(iid: int) -> Tuple[str, int]:
    """Inverse of ``instance_id``."""
    if iid >= BACKUP_BASE:
        return "backup", iid - BACKUP_BASE
    if iid >= PARITY_BASE:
        off = iid - PARITY_BASE
        return f"parity{off // PARITY_STRIDE}", off % PARITY_STRIDE
    return "main", iid


@dataclass(frozen=True)
class Window:
    """One realized hazard interval on (pool, server).

    ``server == -1`` hits every server of the pool (correlated slowdown).
    ``until_restart`` models a crash: a query dispatched at ``now`` inside
    the window waits out the remaining downtime ``t1 - now`` before service
    starts. Otherwise service time becomes ``base * mult + U[add_lo, add_hi]``.
    ``corrupt`` marks a Byzantine window: responses computed inside it are
    erroneous (the delay knobs still apply — a failing node is typically
    slow AND wrong, which is also what gives a voting decoder the surplus
    of clean responses it needs).
    """
    pool: str
    server: int
    t0: float
    t1: float
    mult: float = 1.0
    add_lo: float = 0.0
    add_hi: float = 0.0
    until_restart: bool = False
    corrupt: bool = False


class FaultPlan:
    """Realized hazards: slowdown windows + static per-server rate
    multipliers, queryable by (pool, server, time).

    Windows are bucketed per (pool, server) — pool-wide windows under
    server -1 — each bucket holding parallel sorted ``t0``/``t1`` arrays:
    a lookup advances a per-bucket cursor past leading windows that ended
    before ``now`` (both consumers query with (near-)monotonic time — the
    DES pops events in time order, the runtime adapter passes wall-clock)
    and bisects the start-time array for the upper bound, so a lookup
    touches only the handful of windows straddling ``now`` instead of
    rescanning — or slice-copying — the bucket's tail."""

    def __init__(self, windows: List[Window],
                 rates: Dict[Tuple[str, int], float]):
        self._wins: Dict[Tuple[str, int], List[Window]] = {}
        for w in windows:
            self._wins.setdefault((w.pool, w.server), []).append(w)
        self._t0s: Dict[Tuple[str, int], List[float]] = {}
        self._t1s: Dict[Tuple[str, int], List[float]] = {}
        for key, ws in self._wins.items():
            ws.sort(key=lambda w: w.t0)
            self._t0s[key] = [w.t0 for w in ws]
            self._t1s[key] = [w.t1 for w in ws]
        self._cursor = {key: 0 for key in self._wins}
        self.rates = rates
        self.n_windows = len(windows)
        self.n_corrupt = sum(1 for w in windows if w.corrupt)
        self._pools = (frozenset(p for p, _ in self._wins)
                       | frozenset(p for p, _ in rates))

    def relevant(self, pool: str) -> bool:
        """Hot-path gate: does this plan ever touch ``pool`` (any window or
        rate multiplier, at any time)?  A False answer lets the DES skip
        the per-dispatch ``adjust_service_ms`` call entirely — on calm or
        narrowly-targeted scenarios that is every dispatch."""
        return pool in self._pools

    def _active(self, pool, server, now):
        for key in ((pool, server), (pool, -1)):
            ws = self._wins.get(key)
            if not ws:
                continue
            t1s = self._t1s[key]
            i = self._cursor[key]
            # drop leading windows that ended before ``now`` for good
            while i < len(ws) and t1s[i] <= now:
                i += 1
            self._cursor[key] = i
            for j in range(i, bisect_right(self._t0s[key], now, i)):
                if now < t1s[j]:
                    yield ws[j]

    def rate(self, pool, server) -> float:
        return self.rates.get((pool, server), 1.0) * \
            self.rates.get((pool, -1), 1.0)

    def adjust_service_ms(self, pool, server, now, base_ms, rng) -> float:
        """DES hook: service time of a query dispatched at ``now``."""
        base_ms *= self.rate(pool, server)
        for w in self._active(pool, server, now):
            if w.until_restart:
                base_ms += w.t1 - now
            else:
                base_ms = base_ms * w.mult + rng.uniform(w.add_lo, w.add_hi)
        return base_ms

    def injected_delay_ms(self, pool, server, now, rng) -> float:
        """Runtime hook: additive delay only (real inference can't be
        scaled), crash downtime included."""
        extra = 0.0
        for w in self._active(pool, server, now):
            if w.until_restart:
                extra += w.t1 - now
            else:
                extra += rng.uniform(w.add_lo, w.add_hi)
        return extra

    def corrupts(self, pool, server, now) -> bool:
        """Byzantine hook, both engines: is a corrupt window active on
        (pool, server) at ``now`` — i.e. is a response computed now
        erroneous?  (Delay injection for these windows flows through the
        two hooks above like any other window.)"""
        return any(w.corrupt for w in self._active(pool, server, now))


def _recurring(rng, horizon_ms, first, dur_rng, gap_rng):
    """Yield (t0, t1) windows of a recurring on/off process until horizon."""
    t = first
    while t <= horizon_ms:
        dur = rng.uniform(*dur_rng)
        yield t, t + dur
        t += dur + rng.uniform(*gap_rng)


def _target_pools(pool: str, pool_sizes: Dict[str, int]) -> List[str]:
    if pool == "*":
        return sorted(pool_sizes)
    if pool == "parity*":
        return sorted(p for p in pool_sizes if p.startswith("parity"))
    if pool not in pool_sizes:
        return []
    return [pool]


@dataclass(frozen=True)
class NetworkShuffles:
    """§5.1 background traffic: each of ``n_tenants`` repeatedly congests
    the link of one randomly chosen instance; queries it serves meanwhile
    pay an extra transfer delay."""
    n_tenants: int = 4
    duration_ms: tuple = (300.0, 700.0)
    gap_ms: tuple = (800.0, 2400.0)
    delay_ms: tuple = (10.0, 40.0)
    slowdown: float = 1.0

    def realize(self, pool_sizes, horizon_ms, rng):
        windows = []
        pools = sorted(pool_sizes)
        for _ in range(self.n_tenants):
            for t0, t1 in _recurring(rng, horizon_ms, rng.uniform(0, 50.0),
                                     self.duration_ms, self.gap_ms):
                pool = pools[rng.integers(len(pools))]
                srv = int(rng.integers(pool_sizes[pool]))
                windows.append(Window(pool, srv, t0, t1, mult=self.slowdown,
                                      add_lo=self.delay_ms[0],
                                      add_hi=self.delay_ms[1]))
        return windows, {}


@dataclass(frozen=True)
class InstanceCrash:
    """Crash/restart process per server: exponential time-between-failures,
    uniform downtime. A query dispatched to a crashed server waits out the
    remaining downtime (the runtime adapter sleeps it)."""
    pool: str = "*"
    mtbf_ms: float = 20_000.0
    downtime_ms: tuple = (500.0, 2000.0)

    def realize(self, pool_sizes, horizon_ms, rng):
        windows = []
        for pool in _target_pools(self.pool, pool_sizes):
            for s in range(pool_sizes[pool]):
                t = rng.exponential(self.mtbf_ms)
                while t <= horizon_ms:
                    down = rng.uniform(*self.downtime_ms)
                    windows.append(Window(pool, s, t, t + down,
                                          until_restart=True))
                    t += down + rng.exponential(self.mtbf_ms)
        return windows, {}


@dataclass(frozen=True)
class CorrelatedSlowdown:
    """Recurring slowdowns that hit an entire pool at once (shared switch,
    co-located noisy neighbor) — the failure mode replication-style schemes
    are most sensitive to."""
    pool: str = "*"                   # "*" = a random pool per event
    duration_ms: tuple = (400.0, 900.0)
    gap_ms: tuple = (1500.0, 4000.0)
    delay_ms: tuple = (15.0, 50.0)
    slowdown: float = 1.0

    def realize(self, pool_sizes, horizon_ms, rng):
        windows = []
        pools = _target_pools(self.pool, pool_sizes)
        if not pools:
            return [], {}
        for t0, t1 in _recurring(rng, horizon_ms, rng.uniform(0, 100.0),
                                 self.duration_ms, self.gap_ms):
            pool = pools[rng.integers(len(pools))]
            windows.append(Window(pool, -1, t0, t1, mult=self.slowdown,
                                  add_lo=self.delay_ms[0],
                                  add_hi=self.delay_ms[1]))
        return windows, {}


@dataclass(frozen=True)
class HeterogeneousRates:
    """Static per-server service-rate spread (mixed hardware generations):
    each server's mean service time is scaled by lognormal(0, sigma)."""
    pool: str = "*"
    sigma: float = 0.15

    def realize(self, pool_sizes, horizon_ms, rng):
        rates = {}
        for pool in _target_pools(self.pool, pool_sizes):
            for s in range(pool_sizes[pool]):
                rates[(pool, s)] = float(np.exp(rng.normal(0.0, self.sigma)))
        return [], rates


@dataclass(frozen=True)
class DeterministicSlowdown:
    """Explicitly targeted slowdown windows — the building block of the
    differential tests, where both serving layers must see the *same*
    unavailability pattern."""
    targets: tuple                    # of (pool, server)
    add_ms: float = 1000.0
    t0: float = 0.0
    t1: float = float("inf")
    mult: float = 1.0

    def realize(self, pool_sizes, horizon_ms, rng):
        return [Window(pool, server, self.t0, self.t1, mult=self.mult,
                       add_lo=self.add_ms, add_hi=self.add_ms)
                for pool, server in self.targets], {}


@dataclass(frozen=True)
class CorruptOutputs:
    """Byzantine hazard: recurring per-server episodes during which every
    response the server computes is erroneous (silent data corruption, a
    wedged accelerator, an adversarial replica).  Episodes also add a
    transfer-scale delay — a failing node is slow as well as wrong — which
    is what lets a ``detects_errors`` scheme accumulate the surplus of
    clean responses it needs to vote the garbage out.

    Exponential time-between-episodes (``mtbe_ms``), uniform duration."""

    pool: str = "main"
    mtbe_ms: float = 6000.0
    duration_ms: tuple = (150.0, 450.0)
    delay_ms: tuple = (20.0, 60.0)

    def realize(self, pool_sizes, horizon_ms, rng):
        windows = []
        for pool in _target_pools(self.pool, pool_sizes):
            for s in range(pool_sizes[pool]):
                t = rng.exponential(self.mtbe_ms)
                while t <= horizon_ms:
                    dur = rng.uniform(*self.duration_ms)
                    windows.append(Window(pool, s, t, t + dur,
                                          add_lo=self.delay_ms[0],
                                          add_hi=self.delay_ms[1],
                                          corrupt=True))
                    t += dur + rng.exponential(self.mtbe_ms)
        return windows, {}


@dataclass(frozen=True)
class DeterministicCorruption:
    """Explicitly targeted Byzantine windows — the corrupt-output analogue
    of ``DeterministicSlowdown``, for tests where both serving layers must
    see the *same* erroneous responses."""

    targets: tuple                    # of (pool, server)
    t0: float = 0.0
    t1: float = float("inf")
    add_ms: float = 0.0

    def realize(self, pool_sizes, horizon_ms, rng):
        return [Window(pool, server, self.t0, self.t1,
                       add_lo=self.add_ms, add_hi=self.add_ms, corrupt=True)
                for pool, server in self.targets], {}


@dataclass(frozen=True)
class DeterministicArrivals:
    """Explicit arrival times — the arrival-process analogue of
    ``DeterministicSlowdown`` for differential tests: the DES reads these
    exact times off the scenario, and the threads-engine side of the test
    paces its ``submit`` calls to the same schedule, so both engines see
    one arrival pattern (and close identical controller windows)."""

    times_ms: tuple

    def realize(self, pool_sizes, horizon_ms, rng):
        return [], {}

    def arrival_times(self, cfg, rng):
        if cfg.n_queries > len(self.times_ms):
            raise ValueError(
                f"DeterministicArrivals holds {len(self.times_ms)} arrival "
                f"times but the trace asks for {cfg.n_queries} queries")
        return np.asarray(self.times_ms[:cfg.n_queries], dtype=float)


@dataclass(frozen=True)
class BurstyArrivals:
    """Two-state Markov-modulated Poisson process (MMPP): calm periods at
    the configured qps, bursts at ``burst_mult`` times it."""
    burst_mult: float = 3.0
    calm_ms: tuple = (2000.0, 6000.0)
    burst_ms: tuple = (300.0, 1200.0)

    def realize(self, pool_sizes, horizon_ms, rng):
        return [], {}

    def arrival_times(self, cfg, rng):
        n = cfg.n_queries
        times = np.empty(n)
        i, t, burst = 0, 0.0, False
        while i < n:
            seg_end = t + rng.uniform(*(self.burst_ms if burst
                                        else self.calm_ms))
            rate = cfg.qps * (self.burst_mult if burst else 1.0)
            while i < n:
                nxt = t + rng.exponential(1000.0 / rate)
                if nxt > seg_end:
                    t = seg_end
                    break
                t = nxt
                times[i] = t
                i += 1
            burst = not burst
        return times


def _thinned_arrivals(n: int, peak_qps: float, accept_fn, rng) -> np.ndarray:
    """Nonhomogeneous Poisson process via chunked, vectorized thinning:
    candidate arrivals are drawn at the peak rate in blocks, then kept with
    probability ``rate(t) / peak`` (``accept_fn`` maps a time array to that
    ratio).  Returns the first ``n`` accepted times, sorted."""
    out = np.empty(n)
    have, t = 0, 0.0
    chunk = int(max(1024, min(4 * n, 1 << 16)))
    mean_gap = 1000.0 / peak_qps
    while have < n:
        cand = t + np.cumsum(rng.exponential(mean_gap, chunk))
        keep = cand[rng.random(chunk) < accept_fn(cand)]
        take = min(keep.size, n - have)
        out[have:have + take] = keep[:take]
        have += take
        t = cand[-1]
    return out


@dataclass(frozen=True)
class TraceArrivals:
    """Replay an explicit arrival-timestamp trace (production logs, a
    public cluster trace, a recorded incident).  If the trace holds fewer
    timestamps than the run asks for it is tiled cyclically: each replayed
    epoch is shifted by the trace span plus one mean inter-arrival gap, so
    the seam between epochs carries the trace's own average spacing rather
    than a zero-gap collision (set ``cycle=False`` to make a short trace a
    hard error instead)."""

    times_ms: tuple
    cycle: bool = True

    def realize(self, pool_sizes, horizon_ms, rng):
        return [], {}

    def arrival_times(self, cfg, rng):
        ts = np.asarray(self.times_ms, dtype=float)
        if ts.ndim != 1 or ts.size == 0:
            raise ValueError("TraceArrivals needs a non-empty 1-D trace")
        if ts.size > 1 and np.any(np.diff(ts) < 0):
            raise ValueError("TraceArrivals trace must be non-decreasing")
        n = cfg.n_queries
        if n <= ts.size:
            return ts[:n].copy()
        if not self.cycle:
            raise ValueError(
                f"TraceArrivals holds {ts.size} arrival times but the "
                f"trace asks for {n} queries (cycle=False)")
        gap = (ts[-1] - ts[0]) / max(ts.size - 1, 1)
        period = (ts[-1] - ts[0]) + max(gap, 1e-9)
        reps = -(-n // ts.size)
        base = ts - ts[0]
        out = np.concatenate([base + i * period for i in range(reps)])
        return out[:n] + ts[0]


@dataclass(frozen=True)
class DiurnalArrivals:
    """Sinusoidal day/night load: a nonhomogeneous Poisson process with
    ``rate(t) = qps * (1 + amplitude * sin(2*pi*t / period_ms))``, sampled
    by vectorized thinning.  ``cfg.qps`` stays the *mean* rate, so swapping
    ``calm`` for ``diurnal`` holds total offered load fixed while moving
    mass into the peaks — the regime where tail latency earns its keep."""

    period_ms: float = 60_000.0
    amplitude: float = 0.6

    def realize(self, pool_sizes, horizon_ms, rng):
        return [], {}

    def arrival_times(self, cfg, rng):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(
                f"DiurnalArrivals amplitude must be in [0, 1), "
                f"got {self.amplitude}")
        peak = cfg.qps * (1.0 + self.amplitude)
        two_pi = 2.0 * np.pi

        def accept(t):
            return (cfg.qps * (1.0 + self.amplitude
                               * np.sin(two_pi * t / self.period_ms))
                    / peak)

        return _thinned_arrivals(cfg.n_queries, peak, accept, rng)


@dataclass(frozen=True)
class FlashCrowd:
    """Flash-crowd arrivals: baseline Poisson at ``qps`` with a spike every
    ``every_ms`` that multiplies the instantaneous rate by ``spike_mult``
    and decays exponentially (time constant ``decay_ms``) — the
    retweet-storm / cache-expiry shape that overwhelms a pool far faster
    than any MMPP burst."""

    spike_mult: float = 8.0
    every_ms: float = 12_000.0
    decay_ms: float = 1_500.0

    def realize(self, pool_sizes, horizon_ms, rng):
        return [], {}

    def arrival_times(self, cfg, rng):
        if self.spike_mult < 1.0:
            raise ValueError(
                f"FlashCrowd spike_mult must be >= 1, got {self.spike_mult}")
        peak = cfg.qps * self.spike_mult
        excess = self.spike_mult - 1.0

        def accept(t):
            boost = excess * np.exp(-(t % self.every_ms) / self.decay_ms)
            return cfg.qps * (1.0 + boost) / peak

        return _thinned_arrivals(cfg.n_queries, peak, accept, rng)


@dataclass(frozen=True)
class TenantClass:
    """One tenant / SLO class for multi-tenant serving (DESIGN.md §11).

    ``share``  — relative fraction of arriving traffic; the simulator
    normalizes shares over all classes, so ``(3, 1)`` means 75%/25%.
    ``weight`` — weighted-fair-queueing weight at dequeue time: under
    contention a tenant with weight 2 drains twice as fast as weight 1.
    ``slo_ms`` — per-class latency SLO for the per-tenant violation
    breakdown; ``None`` inherits the trace-level ``slo_ms``.
    """

    name: str
    share: float = 1.0
    weight: float = 1.0
    slo_ms: Optional[float] = None

    def __post_init__(self):
        if self.share <= 0.0:
            raise ValueError(f"tenant {self.name!r}: share must be > 0")
        if self.weight <= 0.0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.slo_ms is not None and self.slo_ms <= 0.0:
            raise ValueError(f"tenant {self.name!r}: slo_ms must be > 0 "
                             f"(or None to inherit the trace-level SLO)")


@dataclass(frozen=True)
class Scenario:
    """A named, composable set of hazards consumed by both serving layers."""

    name: str
    hazards: tuple = field(default_factory=tuple)

    def arrival_times(self, cfg, rng):
        """Arrival process override, or None for the default Poisson."""
        for h in self.hazards:
            fn = getattr(h, "arrival_times", None)
            if fn is not None:
                return fn(cfg, rng)
        return None

    def realize(self, pool_sizes: Dict[str, int], horizon_ms: float,
                rng) -> FaultPlan:
        windows, rates = [], {}
        for h in self.hazards:
            w, rt = h.realize(pool_sizes, horizon_ms, rng)
            windows.extend(w)
            rates.update(rt)
        return FaultPlan(windows, rates)

    def adapters(self, pool_sizes: Dict[str, int], *, seed: int = 0,
                 horizon_ms: float = 600_000.0, time_scale: float = 1.0,
                 extra=None):
        """Both threaded-runtime fault adapters off ONE realized plan and
        one wall-clock origin: ``(delay_fn, corrupt_fn)``.

        ``delay_fn(iid) -> seconds`` maps each worker's instance id to its
        (pool, server) window set by wall-clock time; ``extra`` composes
        with a user-provided delay_fn (delays add).  ``random.Random`` is
        used for per-query jitter — its single-call draws are safe under
        CPython's GIL for concurrent workers.

        ``corrupt_fn(iid) -> bool`` is the Byzantine twin: True while a
        corrupt window is active on the worker's (pool, server), reading
        the SAME windows by the SAME clock (a separately-realized plan
        would skew the two adapters by their setup gap).  It is ``None``
        when the plan holds no corrupt windows, so frontends skip wiring
        the output-corruption path — and its screening — entirely."""
        plan = self.realize(pool_sizes, horizon_ms,
                            np.random.default_rng(seed))
        jitter = _random.Random(seed + 1)
        origin = time.perf_counter()

        class _Jitter:                   # FaultPlan expects rng.uniform(a, b)
            uniform = staticmethod(jitter.uniform)

        def now_ms():
            return (time.perf_counter() - origin) * 1e3 / time_scale

        def delay(iid):
            pool, server = pool_of_iid(iid)
            d = plan.injected_delay_ms(pool, server, now_ms(), _Jitter)
            d_s = d * time_scale / 1e3
            if extra is not None:
                d_s += extra(iid)
            return d_s

        if plan.n_corrupt == 0:
            return delay, None

        def corrupt(iid):
            pool, server = pool_of_iid(iid)
            return plan.corrupts(pool, server, now_ms())

        return delay, corrupt

    def delay_fn(self, pool_sizes: Dict[str, int], *, seed: int = 0,
                 horizon_ms: float = 600_000.0, time_scale: float = 1.0,
                 extra=None):
        """The delay adapter alone (see ``adapters``).  There is
        deliberately no standalone corrupt-adapter helper: the two
        injectors must share one realized plan and one clock origin, so
        callers that want both go through ``adapters``."""
        return self.adapters(pool_sizes, seed=seed, horizon_ms=horizon_ms,
                             time_scale=time_scale, extra=extra)[0]


# --------------------------------------------------------------- registry ---
_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    """Register a scenario instance under its ``name``."""
    _SCENARIOS[scenario.name] = scenario
    return scenario


def list_scenarios() -> list:
    """Introspection: registered scenario names, sorted.  Every listed name
    resolves via ``get_scenario(name)``."""
    return sorted(_SCENARIOS)


def available_scenarios():
    return list_scenarios()


def get_scenario(scenario: Union[str, Scenario]) -> Scenario:
    """Resolve a name (or pass an instance through)."""
    if isinstance(scenario, Scenario):
        return scenario
    if isinstance(scenario, str):
        if scenario not in _SCENARIOS:
            raise KeyError(
                f"unknown scenario {scenario!r}; registered: "
                f"{available_scenarios()}")
        return _SCENARIOS[scenario]
    raise TypeError(f"not a Scenario or registered name: {scenario!r}")


register_scenario(Scenario("calm"))
register_scenario(Scenario("shuffle", (NetworkShuffles(),)))
register_scenario(Scenario("crash", (InstanceCrash(),)))
register_scenario(Scenario("correlated_slowdown", (CorrelatedSlowdown(),)))
register_scenario(Scenario("bursty", (BurstyArrivals(),
                                      NetworkShuffles(n_tenants=2))))
register_scenario(Scenario("hetero", (HeterogeneousRates(),
                                      NetworkShuffles(n_tenants=2))))
register_scenario(Scenario("byzantine", (CorruptOutputs(),)))
register_scenario(Scenario("diurnal", (DiurnalArrivals(),)))
register_scenario(Scenario("flash_crowd", (FlashCrowd(),)))
register_scenario(Scenario("storm", (NetworkShuffles(),
                                     InstanceCrash(mtbf_ms=40_000.0),
                                     CorrelatedSlowdown(),
                                     BurstyArrivals(burst_mult=2.0))))
