"""Closed-loop adaptive-redundancy controllers for the serving stack.

ParM's evaluation (paper §7) fixes ``(scheme, k, r)`` at deploy time, but
real clusters alternate calm periods with bursts and correlated slowdowns.
ApproxIFER's runtime-adaptive decoding shows redundancy can change *without
retraining*: the ``approxifer`` scheme is ``model_agnostic`` (its parity
pool runs the deployed parameters) with a ``dynamic_arity`` decoder, so
escalating from r=1 to r=2 at runtime needs no new parity model — only the
control loop this module provides.

A ``Controller`` watches the sliding window of serving signals both engines
emit (``repro.serving.report.ReportWindow``: per-window p50/p999 and
straggler / corruption / cancellation rates) and answers each window with an
``Adjustment`` — or ``None`` to hold.  The engines apply adjustments at the
next coding-group boundary (threads) / as events on the simulation clock
(DES), so the differential battery can assert identical decision sequences
across engines.

The protocol is deliberately *functional*: a controller instance is frozen
and stateless, and its evolving memory lives in an opaque state value::

    state = controller.init(base)                  # base: the deployed knobs
    adjustment, state = controller.observe(state, window)   # every window

One instance can therefore drive both engines of a differential test (or
many concurrent replays) without cross-talk.  The full protocol:

``name``                — registry identity, surfaced in ``ServingReport``;
``window_ms``           — observation-window length in *scenario* time
                          (simulated ms in the DES; the threads engine
                          divides wall-clock by ``scenario_time_scale``);
``init(base)``          — initial state.  ``base`` is an ``Adjustment``
                          holding the deployment's own scheme/r/batching,
                          i.e. what "de-escalate" should return to;
``observe(state, w)``   — one closed ``ReportWindow`` in, ``(Adjustment |
                          None, new_state)`` out;
``max_r(base_r)``       — the largest ``r`` any adjustment may request;
``escalation_r(base_r)``— how many *deployed-params* parity pools the
                          engines must provision up front, beyond the
                          deployment's own ``parity_params`` pools.  Any
                          adjustment that is not an exact return to the
                          deployment base is dispatched to these pools,
                          whose workers run the deployed model — correct
                          exactly for a ``model_agnostic`` escalation
                          target like ``approxifer`` (the reason the
                          default escalation goes there rather than to a
                          trained parity model that does not exist at
                          runtime); the engines REJECT non-agnostic
                          escalation targets at adjustment time.  Return 0
                          for a controller that never leaves the base
                          (``static``), so its pool layout — and thus any
                          seeded hazard realization — is identical to a
                          controller-less deployment.  Optional: engines
                          fall back to ``max_r(base_r)`` (conservative)
                          when a controller does not define it.

Built-ins (``register_controller`` / ``get_controller``):

``static``       — the no-op baseline: observes, never adjusts;
``threshold``    — escalate-and-hold bang-bang: escalate to (``approxifer``,
                   r=2, batched) the moment a window is *hot*
                   (straggler/corruption rate or p999/p50 tail ratio above
                   threshold), drop back to the deployment base only after
                   ``down_windows`` consecutive genuinely *calm* windows;
``hysteresis``   — the same thresholds debounced in both directions:
                   ``up_windows`` consecutive hot windows to escalate and a
                   deeper calm streak to de-escalate, so a flapping signal
                   cannot make the deployment flap with it.

Controllers enumerate candidate actions through the registries'
introspection helpers (``list_schemes`` / ``list_strategies`` /
``list_scenarios``) — the threshold family validates its escalation target
against ``list_schemes()`` at construction, so a typo fails at deploy time,
not mid-run.  See DESIGN.md §10 for the authoring guide.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core.scheme import list_schemes
from repro_torch.serving.report import ReportWindow


@dataclass(frozen=True)
class Adjustment:
    """One retuning action: every field is optional, ``None`` means "keep
    the current value".  For a non-coded strategy the engines apply only
    ``batch_max_size`` (there is no scheme or parity pool to retune)."""

    scheme: Optional[str] = None
    r: Optional[int] = None
    batch_max_size: Optional[int] = None

    def __post_init__(self):
        if self.r is not None and self.r < 1:
            raise ValueError(f"r must be >= 1, got {self.r}")
        if self.batch_max_size is not None and self.batch_max_size < 1:
            raise ValueError(
                f"batch_max_size must be >= 1, got {self.batch_max_size}")


@dataclass(frozen=True)
class _BangBangState:
    """Functional state of the threshold/hysteresis family: which mode the
    loop is in, the current hot/calm streaks, the deployment base the
    de-escalation returns to, and the calm-reference p50 (the running
    minimum of window medians — queueing can only raise a window's p50
    above the unloaded service time, so the minimum tracks the calm
    level)."""
    base: Adjustment
    mode: str = "base"              # "base" | "escalated"
    hot_streak: int = 0
    calm_streak: int = 0
    ref_p50: float = float("inf")


@dataclass(frozen=True)
class StaticController:
    """The no-op baseline: observes every window, never adjusts.  Exists so
    'controller overhead without actions' is a measurable point and so
    sweeps can treat 'no controller' as just another registered name."""

    window_ms: float = 1000.0
    name: str = "static"

    def init(self, base: Adjustment):
        return None

    def observe(self, state, window: ReportWindow):
        return None, state

    def max_r(self, base_r: int) -> int:
        return base_r

    def escalation_r(self, base_r: int) -> int:
        return 0        # never leaves the base: no extra pools, no RNG drift


@dataclass(frozen=True)
class ThresholdController:
    """Bang-bang controller: escalate on a *hot* window, return to the
    deployment base on a *calm* one.

    A window with completions is **hot** when any of: ``straggler_rate >=
    hot_straggler_rate`` (parity reconstructions are carrying load —
    originals are not arriving in time), ``corruption_rate >=
    hot_corruption_rate`` (Byzantine responses are being voted out), the
    scale-free tail ratio ``p999/p50 >= hot_tail_ratio`` (queueing is
    stretching the tail, the §5 congestion signature), or the window's p50
    sits ``hot_p50_mult`` times above the calm-reference p50 (see below).
    It is **calm** when every signal sits at or below its ``calm_*``
    threshold.  Windows in between — and empty windows, which carry no
    evidence — hold.

    The calm-reference p50 is the running minimum of window medians,
    carried in the functional state.  It exists because the tail ratio is
    scale-free and goes BLIND inside a saturated burst: once the queue
    backs up, every completion is slow, p50 rises with p999, and the ratio
    flattens back under the hot threshold — a fully saturated window can
    read as "calm" by ratio alone.  The absolute level signal (p50 at
    ``hot_p50_mult``x the unloaded median) catches exactly those windows,
    and the matching ``calm_p50_mult`` bound keeps a still-congested
    window from counting toward a de-escalation streak.

    The straggler thresholds are deliberately high (0.45): a reconstruction
    is counted whenever the *parity path* wins the completion race, and with
    an idle parity pool at small k that race is benignly won ~30% of the
    time even on a calm workload.  Thresholds below that benign race rate
    make every window read as hot; thresholds above it leave the straggler
    signal meaning what it should — a genuine main-pool outage (e.g. a
    crashed or frozen instance, where the rate approaches the fraction of
    groups touching the dead instance).  Congestion is instead caught by the
    tail ratio, which is scale-free and insensitive to the race rate.

    The asymmetric debounce (``up_windows=1``, ``down_windows=4``) encodes
    *escalate-and-hold*: react to the first hot window immediately, but only
    stand down after a sustained calm streak.  During alternating
    burst/calm regimes (``bursty``, ``storm``) a symmetric policy flaps —
    and every de-escalation pays one full un-coded burst onset, which is
    exactly the p999 the controller exists to cut.  ``calm_tail_ratio`` sits
    at 1.4 (tight: escalated-mode windows during turbulence score 1.5–2.2)
    so "calm" means genuinely quiet, not merely "the redundancy is working".

    Escalation dispatches ``(escalate_scheme, escalate_r,
    escalate_batch_max)``; the default target is ``approxifer`` because it
    is ``model_agnostic`` — its extra parity pool can run the deployed
    parameters, so r can rise at runtime without any retrained parity model
    — and ``detects_errors``, so the corruption signal is actionable too.
    De-escalation replays the ``base`` adjustment captured at ``init``.
    """

    window_ms: float = 1000.0
    hot_straggler_rate: float = 0.45
    hot_corruption_rate: float = 0.02
    hot_tail_ratio: float = 3.0
    hot_p50_mult: float = 3.0
    calm_straggler_rate: float = 0.45
    calm_corruption_rate: float = 0.0
    calm_tail_ratio: float = 1.4
    calm_p50_mult: float = 1.5
    escalate_scheme: Optional[str] = "approxifer"
    escalate_r: int = 2
    escalate_batch_max: int = 4
    up_windows: int = 1
    down_windows: int = 4
    name: str = "threshold"

    def __post_init__(self):
        if self.escalate_scheme is not None and \
                self.escalate_scheme not in list_schemes():
            raise ValueError(
                f"escalate_scheme {self.escalate_scheme!r} is not a "
                f"registered coding scheme; known: {list_schemes()}")
        if self.escalate_r < 1:
            raise ValueError(f"escalate_r must be >= 1, got "
                             f"{self.escalate_r}")
        if self.up_windows < 1 or self.down_windows < 1:
            raise ValueError("up_windows and down_windows must be >= 1")

    def max_r(self, base_r: int) -> int:
        return max(base_r, self.escalate_r)

    def escalation_r(self, base_r: int) -> int:
        # a "no-op escalation" (same scheme family, same r) would still be
        # dispatched to deployed-params pools; only skip provisioning when
        # the policy can never leave the base at all
        if self.escalate_scheme is None and self.escalate_r == base_r:
            return 0
        return self.escalate_r

    def init(self, base: Adjustment) -> _BangBangState:
        return _BangBangState(base=base)

    def _classify(self, w: ReportWindow,
                  ref_p50: float = float("inf")) -> Optional[str]:
        if w.n == 0:
            return None                 # no completions: no evidence
        tail = (w.p999_ms / w.p50_ms) if w.p50_ms > 0 else 1.0
        level = (w.p50_ms / ref_p50) if ref_p50 > 0 else 1.0
        if (w.straggler_rate >= self.hot_straggler_rate
                or w.corruption_rate >= self.hot_corruption_rate
                or tail >= self.hot_tail_ratio
                or level >= self.hot_p50_mult):
            return "hot"
        if (w.straggler_rate <= self.calm_straggler_rate
                and w.corruption_rate <= self.calm_corruption_rate
                and tail <= self.calm_tail_ratio
                and level <= self.calm_p50_mult):
            return "calm"
        return None

    def observe(self, state: _BangBangState, window: ReportWindow
                ) -> Tuple[Optional[Adjustment], _BangBangState]:
        ref = state.ref_p50
        if window.n > 0 and window.p50_ms == window.p50_ms:   # not NaN
            ref = min(ref, float(window.p50_ms))
        cls = self._classify(window, ref)
        hot = state.hot_streak + 1 if cls == "hot" else 0
        calm = state.calm_streak + 1 if cls == "calm" else 0
        if state.mode == "base" and hot >= self.up_windows:
            adj = Adjustment(
                scheme=self.escalate_scheme,
                r=self.escalate_r,
                batch_max_size=self.escalate_batch_max
                if self.escalate_batch_max > 1 else None)
            return adj, replace(state, mode="escalated",
                                hot_streak=0, calm_streak=0, ref_p50=ref)
        if state.mode == "escalated" and calm >= self.down_windows:
            return state.base, replace(state, mode="base",
                                       hot_streak=0, calm_streak=0,
                                       ref_p50=ref)
        return None, replace(state, hot_streak=hot, calm_streak=calm,
                             ref_p50=ref)


@dataclass(frozen=True)
class HysteresisController(ThresholdController):
    """The threshold policy debounced on the way *up* as well: two
    consecutive hot windows to escalate (a single noisy window cannot raise
    r) and a deeper calm streak to drop back.  Trades one window of
    reaction latency for immunity to spurious escalations."""

    up_windows: int = 2
    down_windows: int = 6
    name: str = "hysteresis"


# --------------------------------------------------------------- registry ---
_CONTROLLERS: Dict[str, Callable[..., object]] = {}


def register_controller(name: str, factory: Callable[..., object] = None,
                        *, override: bool = False):
    """Register a controller factory ``factory(**kw)`` under ``name``.
    Usable as a decorator, mirroring ``register_scheme``.  Registering a
    *different* factory under an existing name raises unless
    ``override=True`` (same-factory re-registration is a no-op, so module
    re-imports stay safe)."""
    def _register(f):
        if not override and _CONTROLLERS.get(name, f) is not f:
            raise ValueError(
                f"controller {name!r} is already registered; pass "
                f"override=True to replace it")
        _CONTROLLERS[name] = f
        return f
    if factory is None:
        return _register
    return _register(factory)


def list_controllers() -> list:
    """Introspection: registered controller names, sorted.  Every listed
    name resolves via ``get_controller(name)``."""
    return sorted(_CONTROLLERS)


def available_controllers():
    return list_controllers()


def get_controller(controller: Union[str, object], **kw):
    """Resolve ``controller`` to a controller object.

    * a controller *instance* passes through after a duck-type check of the
      protocol surface (``name`` / ``window_ms`` / ``init`` / ``observe`` /
      ``max_r``) — failing at deploy time beats an AttributeError out of an
      engine's window loop;
    * a string is looked up in the registry and instantiated with ``**kw``.
    """
    if not isinstance(controller, str):
        missing = [a for a in ("name", "window_ms", "init", "observe",
                               "max_r") if not hasattr(controller, a)]
        if missing:
            raise TypeError(
                f"not a Controller (missing {missing}) or registered "
                f"name: {controller!r}")
        return controller
    if controller not in _CONTROLLERS:
        raise KeyError(
            f"unknown controller {controller!r}; registered: "
            f"{list_controllers()}")
    return _CONTROLLERS[controller](**kw)


register_controller("static", StaticController)
register_controller("threshold", ThresholdController)
register_controller("hysteresis", HysteresisController)
