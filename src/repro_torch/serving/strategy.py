"""Resilience strategies: one declarative object consumed by BOTH serving
layers (the threaded runtime and the discrete-event simulator).

A ``ResilienceStrategy`` owns the three decisions the paper's §5.1 baselines
differ in, so the two serving implementations cannot drift:

* worker-pool layout      — ``layout(m, k, r)`` -> ``PoolLayout`` (how the
                            redundancy budget m/k is spent: parity instances
                            or extra deployed instances);
* group assembly          — ``coded`` (form coding groups of ``scheme.k``
                            and dispatch parity queries) vs ``mirror``
                            (replicate each query) vs nothing;
* on-unavailability       — decode (coded), first-replica-wins (mirror),
                            Clipper default prediction at the SLO deadline
                            (``slo_default``), or just wait.

Registered strategies (all sized for the paper's apples-to-apples m + m/k
instance budget, §5.1):

  ``parm``            m deployed + m/k parity instances per parity model;
                      coding groups of k; decode on unavailability.
  ``equal_resources`` m + m/k deployed instances, no redundancy.
  ``replication``     every query dispatched twice to the main pool
                      (2x resources; first completion wins).
  ``approx_backup``   m deployed + m/k approximate backups (§5.2.6),
                      expressed as the coded ``approx_backup`` *scheme*
                      (k = 1 cheap model per group, passthrough decode) —
                      no dedicated backup pool exists in either serving
                      layer any more.
  ``default_slo``     m deployed; late predictions replaced by a default at
                      the SLO deadline (§4.1 baseline).
  ``none``            m deployed only (queueing-knee baseline).

New strategies plug in with ``register_strategy`` from any file and are then
runnable end-to-end through ``ParMFrontend`` and ``simulate`` untouched —
and, one level up, through the declarative serving surface: a
``DeploymentSpec(strategy="mine")`` deploys on either engine
(``repro.serving.api.deploy``) the moment the name is registered.

A strategy may also pin a default fault ``scenario`` (a registered name from
``repro.serving.scenarios``); both serving layers resolve it when the caller
does not pass one explicitly, so a strategy can declare the hazard regime it
is meant to be evaluated under.

Serving *policy* — adaptive batching, SLO deadlines, redundant-work
cancellation — deliberately does NOT live here: those are frontend
properties declared on the ``DeploymentSpec`` (``BatchingPolicy``,
``slo_ms``), orthogonal to the resilience strategy (DESIGN.md §8).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Union


@dataclass(frozen=True)
class PoolLayout:
    """Instance counts per pool. ``parity`` is instances *per parity queue*
    in the threaded runtime and the parity-pool size in the simulator."""
    main: int
    parity: int = 0


@dataclass(frozen=True)
class ResilienceStrategy:
    """Declarative strategy; both serving layers interpret the same flags."""

    name: str
    coded: bool = False          # assemble groups of scheme.k, dispatch parity
    mirror: int = 1              # copies of each query sent to the main pool
    slo_default: bool = False    # fulfill with the default prediction at SLO
    extra_main: bool = False     # spend the redundancy budget on main pool
    scheme: Optional[str] = None  # default CodingScheme name (coded only)
    scenario: Optional[str] = None  # default fault Scenario name; None means
                                    # each serving layer's own default (the
                                    # DES's legacy shuffle load, no injection
                                    # in the threaded runtime)

    def n_redundant(self, m: int, k: int) -> int:
        """The paper's redundancy budget: m/k instances (at least 1)."""
        return max(1, m // k)

    def layout(self, m: int, k: int, r: int = 1) -> PoolLayout:
        nr = self.n_redundant(m, k)
        return PoolLayout(
            main=m + (nr * r if self.extra_main else 0),
            parity=nr if self.coded else 0)


# --------------------------------------------------------------- registry ---
_STRATEGIES: Dict[str, ResilienceStrategy] = {}


def register_strategy(strategy: ResilienceStrategy, *,
                      override: bool = False) -> ResilienceStrategy:
    """Register a strategy instance under its ``name``.  Registering a
    *different* strategy under an existing name raises unless
    ``override=True`` (an equal re-registration is a no-op, so module
    re-imports stay safe)."""
    if not override and _STRATEGIES.get(strategy.name, strategy) != strategy:
        raise ValueError(
            f"resilience strategy {strategy.name!r} is already registered; "
            f"pass override=True to replace it")
    _STRATEGIES[strategy.name] = strategy
    return strategy


def list_strategies() -> list:
    """Introspection: registered strategy names, sorted.  Every listed name
    resolves via ``get_strategy(name)``."""
    return sorted(_STRATEGIES)


def available_strategies():
    return list_strategies()


def get_strategy(strategy: Union[str, ResilienceStrategy],
                 **overrides) -> ResilienceStrategy:
    """Resolve a name (or pass an instance through), optionally overriding
    fields, e.g. ``get_strategy("parm", scheme="concat")``."""
    if isinstance(strategy, ResilienceStrategy):
        return replace(strategy, **overrides) if overrides else strategy
    if isinstance(strategy, str):
        if strategy not in _STRATEGIES:
            raise KeyError(
                f"unknown resilience strategy {strategy!r}; registered: "
                f"{available_strategies()}")
        base = _STRATEGIES[strategy]
        return replace(base, **overrides) if overrides else base
    raise TypeError(
        f"not a ResilienceStrategy or registered name: {strategy!r}")


register_strategy(ResilienceStrategy("parm", coded=True, scheme="sum"))
register_strategy(ResilienceStrategy("equal_resources", extra_main=True))
register_strategy(ResilienceStrategy("replication", mirror=2))
register_strategy(ResilienceStrategy("approx_backup", coded=True,
                                     scheme="approx_backup"))
register_strategy(ResilienceStrategy("default_slo", slo_default=True))
register_strategy(ResilienceStrategy("none"))
