"""Declarative serving API: ``DeploymentSpec`` in, ``Session`` out.

ParM is a framework *atop* a prediction-serving system (the paper deploys on
Clipper), so the user-facing serving surface matters as much as the codes.
This module is that surface — one frozen, declarative spec that BOTH serving
layers consume:

    spec = DeploymentSpec(fwd=fwd, params=params, parity_params=pp,
                          strategy="parm", scheme="sum", k=2, m=4,
                          batching=BatchingPolicy(max_size=4, max_delay_ms=2))

    with deploy(spec) as session:                    # engine="threads"
        fut = session.submit(x)                      # -> PredictionFuture
        y = fut.result(timeout=1.0)
        report = session.stats()                     # -> ServingReport

    report = deploy(spec, engine="sim").replay(Trace(n_queries=100_000,
                                                     qps=270.0))

The *same* spec drives the threaded runtime (``engine="threads"`` — real
PyTorch inference on worker threads, on ``spec.device``) and the
discrete-event simulator (``engine="sim"`` — the paper's 100k-query
tail-latency methodology).  The deployment half of the configuration
(model, strategy, scheme, pool budget m/k/r, fault scenario, SLO, batching
policy, device) lives in the spec; the sim-only
workload half (arrival process, query count, calibrated service times) lives
in a ``Trace``, so sweeping workloads never mutates the deployment and
sweeping deployments never re-describes the workload.

``ParMFrontend(...)`` and ``simulate(cfg, ...)`` keep working — the frontend
constructor folds its legacy kwarg surface into a ``DeploymentSpec`` (the
deprecated spellings warn), and ``simulate`` is exactly what
``SimSession.replay`` runs.  See DESIGN.md §8 for the authoring guide.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields, replace
from typing import Any, Callable, Optional, Union

from repro_torch.convert import resolve_device
from repro_torch.core.scheme import get_scheme
from repro_torch.serving.report import ServingReport
from repro_torch.serving.simulator import SimConfig, simulate
from repro_torch.serving.strategy import get_strategy

ENGINES = ("threads", "sim")


@dataclass(frozen=True)
class BatchingPolicy:
    """Clipper-style adaptive batching for the main pool.

    A worker serves up to ``max_size`` queued queries per inference call.
    Batches form *adaptively* from queue depth: an idle server takes
    whatever is waiting (at most ``max_size``) and never holds a lone query
    hostage.  ``max_delay_ms`` is a threads-engine refinement — after
    dequeuing one query a worker waits up to that long for the batch to
    fill; the DES models the size cap only (dequeue-time batching), so keep
    ``max_delay_ms = 0`` when comparing the two engines query-for-query.

    ``max_size = 1`` (the default) disables batching entirely.
    """

    max_size: int = 1
    max_delay_ms: float = 0.0

    def __post_init__(self):
        if self.max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {self.max_size}")
        if self.max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {self.max_delay_ms}")


@dataclass(frozen=True, eq=False)
class DeploymentSpec:
    """Frozen description of one coded-serving deployment.

    Consumed identically by ``deploy(spec, engine="threads")`` and
    ``deploy(spec, engine="sim")``.  ``fwd`` / ``params`` (and
    ``parity_params`` for coded strategies) are required by the threads
    engine and ignored by the DES, which simulates service times instead of
    running inference.

    ``strategy`` / ``scheme`` / ``scenario`` accept registered names or
    instances — the same registries ``ParMFrontend`` and ``simulate``
    resolve.  ``k`` is the redundancy budget (pool sizing); a ``fixes_k``
    scheme may own a different group size.  ``r`` is parity models per group
    (``None``: the scheme's own, default 1).
    """

    # model (threads engine; the DES simulates service instead)
    fwd: Optional[Callable] = None
    params: Any = None
    parity_params: Any = None
    parity_fwd: Optional[Callable] = None

    # resilience
    strategy: Union[str, Any] = "parm"
    scheme: Union[str, Any, None] = None
    backend: Optional[str] = None
    # where the threads engine's schemes run ("cuda" unless the caller asks
    # for "cpu"; resolving "cuda" without a card raises)
    device: str = "cuda"
    k: int = 2
    r: Optional[int] = None
    m: int = 4

    # serving policy
    batching: BatchingPolicy = field(default_factory=BatchingPolicy)
    slo_ms: Optional[float] = None
    default_prediction: Any = None
    # closed-loop retuning: a registered controller name or instance
    # (repro.serving.controller).  Both engines observe ReportWindow
    # snapshots every controller.window_ms and apply its Adjustments at
    # coding-group boundaries; None (the default) disables the loop
    controller: Union[str, Any, None] = None

    # fault injection.  ``scenario`` drives BOTH engines; the three knobs
    # below configure the threads engine's wall-clock fault-injection
    # adapter only — the DES realizes the same hazards from ``Trace.seed``
    # in simulated time (one seed for the whole replay, so seeded DES
    # baselines stay bit-stable)
    scenario: Any = None
    scenario_seed: int = 0
    scenario_time_scale: float = 1.0
    scenario_horizon_ms: float = 600_000.0

    # expert hooks (threads engine)
    delay_fn: Optional[Callable] = None
    encode_fn: Optional[Callable] = None
    decode_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k and m must be >= 1, got k={self.k} "
                             f"m={self.m}")
        if not isinstance(self.batching, BatchingPolicy):
            raise TypeError(
                f"batching must be a BatchingPolicy, got {self.batching!r}")

    def replace(self, **changes) -> "DeploymentSpec":
        """A changed copy (the spec itself is frozen)."""
        return replace(self, **changes)


@dataclass(frozen=True)
class Trace:
    """The sim-only workload half of a deployment: arrival process, query
    count and the calibrated service-time model the DES charges.  Replayed
    against a ``DeploymentSpec`` via ``deploy(spec, engine="sim")
    .replay(trace)``.  Field meanings match ``SimConfig``, and the defaults
    ARE ``SimConfig``'s — the calibration constants live in one place.
    ``seed`` drives every random draw of the replay, scenario hazards
    included (the spec's ``scenario_seed`` is a threads-engine knob)."""

    n_queries: int = SimConfig.n_queries
    qps: float = SimConfig.qps
    service_ms: float = SimConfig.service_ms
    service_cv: float = SimConfig.service_cv
    seed: int = SimConfig.seed
    n_shuffles: int = SimConfig.n_shuffles
    shuffle_ms: tuple = SimConfig.shuffle_ms
    shuffle_gap_ms: tuple = SimConfig.shuffle_gap_ms
    shuffle_delay_ms: tuple = SimConfig.shuffle_delay_ms
    shuffle_slowdown: float = SimConfig.shuffle_slowdown
    encode_ms: float = SimConfig.encode_ms
    decode_ms: float = SimConfig.decode_ms
    approx_speedup: float = SimConfig.approx_speedup
    batch_cost: float = SimConfig.batch_cost
    # multi-tenant mode: a tuple of TenantClass (repro.serving.scenarios)
    # tagging traffic with shares / WFQ weights / per-class SLOs; empty =
    # single-tenant.  DESIGN.md §11
    tenants: tuple = SimConfig.tenants
    # explicit arrival timestamps (ms).  Takes precedence over both the
    # Poisson default and any scenario arrival process — the trace-replay
    # fast lane when timestamps are already in hand (TraceArrivals is the
    # scenario-level spelling, with cycling)
    arrival_times_ms: Optional[tuple] = SimConfig.arrival_times_ms


class PredictionFuture:
    """Async handle for one submitted query: the result, how it completed
    (``model`` | ``parity`` | ``default`` | ``flushed``), its latency, and
    whether the SLO deadline was blown."""

    def __init__(self, query, slo_ms: Optional[float] = None):
        self._query = query
        self._slo_ms = slo_ms

    @property
    def qid(self):
        return self._query.qid

    def done(self) -> bool:
        return self._query.event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the prediction is available (or raise TimeoutError)."""
        if not self._query.event.wait(timeout):
            raise TimeoutError(
                f"query {self._query.qid} unanswered after {timeout}s")
        return self._query.result

    @property
    def completed_by(self) -> str:
        return self._query.completed_by

    @property
    def latency_ms(self) -> float:
        return self._query.latency_ms

    @property
    def deadline_exceeded(self) -> bool:
        """True once the query finished past its SLO (or was answered with
        the default prediction *at* the deadline).  False while pending,
        for deployments without an SLO, and for shutdown-flushed queries —
        their finish time is a teardown artifact, not a latency (the same
        exclusion ``ServingReport`` applies)."""
        if not self.done() or self.completed_by == "flushed":
            return False
        if self.completed_by == "default":
            return True
        return self._slo_ms is not None and self.latency_ms > self._slo_ms

    def __repr__(self):
        # parenthesized: bare ``a or b if c else d`` parses as
        # ``a or (b if c else d)``, which printed a done-but-unattributed
        # future as its falsy completed_by instead of "pending"
        state = (self.completed_by or "pending") if self.done() else "pending"
        return f"PredictionFuture(qid={self.qid}, {state})"


class Session:
    """Base of both engines: context-managed shutdown + report access."""

    engine = ""

    def __init__(self, spec: DeploymentSpec):
        self.spec = spec

    def submit(self, x, qid=None) -> PredictionFuture:
        raise NotImplementedError

    def stats(self) -> ServingReport:
        raise NotImplementedError

    def shutdown(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


class ThreadsSession(Session):
    """The threaded runtime behind the declarative surface: real PyTorch
    inference on ``ModelInstance`` worker threads, driven by the spec."""

    engine = "threads"

    def __init__(self, spec: DeploymentSpec):
        super().__init__(spec)
        if spec.fwd is None or spec.params is None:
            raise ValueError(
                "engine='threads' runs real inference: DeploymentSpec needs "
                "fwd= and params= (the sim engine does not)")
        from repro_torch.serving.runtime import ParMFrontend
        self._frontend = ParMFrontend(spec=spec)
        self._next_qid = 0
        self._submitted = set()
        self._lock = threading.Lock()

    def submit(self, x, qid=None) -> PredictionFuture:
        """Submit one query batch; returns immediately with a future.

        ``qid`` defaults to an auto-assigned id; an explicit one must be
        fresh — reuse would overwrite the earlier query's bookkeeping and
        orphan its future, so it raises instead.  The auto counter always
        skips past explicit ids.  The id is *reserved* under the session
        lock (not merely checked), so concurrent submitters cannot race two
        queries onto one qid."""
        with self._lock:
            if qid is None:
                qid = self._next_qid
            elif qid in self._submitted:
                raise ValueError(f"qid {qid} was already submitted")
            self._submitted.add(qid)
            self._next_qid = max(self._next_qid, qid + 1)
        q = self._frontend.submit(qid, x)
        return PredictionFuture(q, slo_ms=self.spec.slo_ms)

    def wait_all(self, timeout: float = 60.0) -> bool:
        return self._frontend.wait_all(timeout=timeout)

    def stats(self) -> ServingReport:
        return self._frontend.stats()

    def shutdown(self):
        self._frontend.shutdown()

    @property
    def frontend(self):
        """Escape hatch to the underlying ``ParMFrontend``."""
        return self._frontend


class SimSession(Session):
    """The discrete-event simulator behind the declarative surface.

    The DES is trace-driven — workloads arrive as a whole (``replay``), not
    query-by-query — so ``submit`` raises and points at ``replay``.
    """

    engine = "sim"

    def __init__(self, spec: DeploymentSpec):
        super().__init__(spec)
        self._last: Optional[ServingReport] = None

    def replay(self, trace: Optional[Trace] = None,
               **overrides) -> ServingReport:
        """Run the spec's deployment against a workload trace.

        ``overrides`` are ``Trace`` field overrides for one-off replays:
        ``session.replay(qps=330)``.  All randomness — arrivals, service
        draws AND scenario hazard realization — derives from ``trace.seed``
        (the spec's ``scenario_seed`` configures only the threads engine's
        wall-clock adapter).
        """
        trace = replace(trace or Trace(), **overrides) if overrides \
            else (trace or Trace())
        spec = self.spec
        # every Trace field maps 1:1 onto its SimConfig namesake (the
        # schema-lock test pins names AND defaults), so a workload field
        # added to both can never be silently dropped here.  The splat is a
        # *shallow* field read — asdict() would recurse into TenantClass
        # entries and hand SimConfig plain dicts instead
        # the DES runs no tensor math, but it resolves the scheme exactly
        # like the threads engine; resolve it here on the spec's device so
        # both engines build the same scheme object
        scheme = spec.scheme if spec.scheme is not None else \
            (get_strategy(spec.strategy).scheme or "sum")
        if isinstance(scheme, str):
            scheme = get_scheme(scheme, k=spec.k,
                                r=1 if spec.r is None else spec.r,
                                backend=spec.backend, device=spec.device)
        cfg = SimConfig(
            **{f.name: getattr(trace, f.name) for f in fields(trace)},
            m=spec.m, k=spec.k,
            r=1 if spec.r is None else spec.r,
            # None disables the deadline — exactly like the threads engine,
            # which arms no SLO timers without an explicit spec.slo_ms
            slo_ms=spec.slo_ms,
            batch_max_size=spec.batching.max_size)
        self._last = simulate(cfg, spec.strategy, scheme=scheme,
                              scenario=spec.scenario, backend=spec.backend,
                              controller=spec.controller, device=spec.device)
        return self._last

    def submit(self, x, qid=None) -> PredictionFuture:
        raise RuntimeError(
            "the sim engine is trace-driven: use "
            "deploy(spec, engine='sim').replay(Trace(...)); per-query "
            "submit() is the threads engine's surface")

    def stats(self) -> ServingReport:
        if self._last is None:
            raise RuntimeError("no replay has run yet — call "
                               "session.replay(Trace(...)) first")
        return self._last


def deploy(spec: DeploymentSpec, engine: str = "threads") -> Session:
    """Bring a ``DeploymentSpec`` up on one of the two serving engines.

    ``threads`` — the real runtime (``ParMFrontend`` worker threads);
    ``sim``     — the DES (``simulate``), reached through ``replay(trace)``.
    """
    if not isinstance(spec, DeploymentSpec):
        raise TypeError(f"deploy() takes a DeploymentSpec, got {spec!r}")
    if engine == "threads":
        resolve_device(spec.device)
        return ThreadsSession(spec)
    if engine == "sim":
        return SimSession(spec)
    raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")



def deploy_lm(spec, engine: str = "threads"):
    """Generation sibling of ``deploy``: takes a ``GenerationSpec`` and
    returns a coded LM serving session (token-level continuous batching,
    per-step parity reconstruction — ``repro_torch.serving.generation``).
    Lazy import so one-shot deployments never pay for the generation stack."""
    from repro_torch.serving.generation import deploy_lm as _deploy_lm
    return _deploy_lm(spec, engine)
