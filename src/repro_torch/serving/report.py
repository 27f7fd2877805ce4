"""The one typed serving report shared by BOTH serving layers.

``ServingReport`` replaces the two hand-rolled result dicts the threaded
``ParMFrontend.stats()`` and the DES ``simulate()`` used to return.  It is a
frozen dataclass — fields are the contract, and a field added here shows up
in both engines at once — but it also implements the ``Mapping`` protocol, so
every existing ``report["p999_ms"]``-style call site keeps working unchanged.

New in this report (vs the old dicts):

* ``engine``                           — ``"threads"`` or ``"sim"``;
* ``completed_by``                     — per-completion-path counts from the
                                         DES too (the runtime always had them);
* ``cancelled_queries`` / ``cancelled_parities`` — redundant-work
  cancellation: originals tombstoned after a parity decode beat them (and
  mirror copies of already-answered queries), and undispatched parity queries
  dropped because every original in their group already finished;
* ``batches`` / ``mean_batch_size``    — adaptive-batching bookkeeping: how
  many main-pool inference calls ran and how many queries each carried;
* ``corrupted_detected`` / ``corrected`` — Byzantine bookkeeping: erroneous
  responses a ``detects_errors`` scheme (approxifer) voted out, and how
  many of the affected predictions were nonetheless served from a clean
  reconstruction.  Both default to 0, so report consumers and schemes that
  never inject or detect errors are unaffected;
* ``controller`` / ``windows`` / ``adjustments`` / ``parity_served`` —
  closed-loop bookkeeping (``repro.serving.controller``): which controller
  watched the run, how many ``ReportWindow`` snapshots it observed, the
  ``(window, scheme, r, batch_max_size)`` adjustment log it produced, and
  how many parity-pool inference items the run actually served (the
  resource axis of the adaptive-vs-static frontier).

``ReportWindow`` is the *incremental* snapshot the same two engines hand a
``Controller`` every ``window_ms``: per-window p50/p999 plus the straggler /
corruption / cancellation rates, all guarded by ``_safe_rate`` so a window
that closes with zero completed queries reports 0.0 rates instead of raising.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field, fields
from typing import Dict, Optional

import numpy as np


def _safe_rate(num, den) -> float:
    """``num / den`` with the empty-window guard both report types share:
    zero completions means "no evidence", reported as a 0.0 rate — never a
    ZeroDivisionError out of a quiet window."""
    return float(num) / float(den) if den else 0.0


@dataclass(frozen=True, eq=True)
class ReportWindow:
    """One closed observation window of a serving run.

    The sliding-window counterpart of ``ServingReport``: both engines close
    one every ``Controller.window_ms`` (simulated ms in the DES, scaled
    wall-clock in the threads engine) and hand it to
    ``Controller.observe``.  ``n`` counts queries *completed* inside
    [``t0_ms``, ``t1_ms``); the rates are relative to it, empty-window safe
    via ``_safe_rate``.
    """

    index: int = 0
    t0_ms: float = 0.0
    t1_ms: float = 0.0
    n: int = 0
    p50_ms: float = float("nan")
    p999_ms: float = float("nan")
    reconstructions: int = 0
    corrupted_detected: int = 0
    cancellations: int = 0

    @property
    def straggler_rate(self) -> float:
        """Fraction of this window's completions served by a parity
        reconstruction — i.e. whose original was unavailable in time."""
        return _safe_rate(self.reconstructions, self.n)

    @property
    def corruption_rate(self) -> float:
        return _safe_rate(self.corrupted_detected, self.n)

    @property
    def cancellation_rate(self) -> float:
        return _safe_rate(self.cancellations, self.n)


def build_window(index, t0_ms, t1_ms, records, *, corrupted_detected=0,
                 cancellations=0) -> ReportWindow:
    """Assemble a ``ReportWindow`` from per-completion records — the one
    construction path both engines share, so their window semantics cannot
    drift.  ``records`` is a sequence of ``(latency_ms, is_reconstruction)``
    pairs for queries completed inside the window; the counter deltas are
    per-window (not cumulative)."""
    n = len(records)
    lats = np.asarray([rec[0] for rec in records], dtype=float)
    return ReportWindow(
        index=int(index), t0_ms=float(t0_ms), t1_ms=float(t1_ms), n=n,
        p50_ms=float(np.percentile(lats, 50)) if n else float("nan"),
        p999_ms=float(np.percentile(lats, 99.9)) if n else float("nan"),
        reconstructions=sum(1 for rec in records if rec[1]),
        corrupted_detected=int(corrupted_detected),
        cancellations=int(cancellations))


@dataclass(frozen=True, eq=True)
class ServingReport(Mapping):
    """Latency percentiles + completion bookkeeping for one serving run.

    Queries flushed at shutdown appear in ``completed_by`` but are excluded
    from the latency percentiles and ``n`` — their finish time is a shutdown
    artifact, not a latency.
    """

    engine: str = "threads"
    strategy: str = ""
    scheme: Optional[str] = None
    scenario: Optional[str] = None
    n: int = 0
    median_ms: float = float("nan")
    p99_ms: float = float("nan")
    p999_ms: float = float("nan")
    mean_ms: float = float("nan")
    max_ms: float = float("nan")
    # hash=False: the dict would break the frozen dataclass's generated
    # __hash__; equality still compares it field-wise
    completed_by: Dict[str, int] = field(default_factory=dict, hash=False)
    reconstructions: int = 0
    cancelled_queries: int = 0
    cancelled_parities: int = 0
    batches: int = 0
    mean_batch_size: float = 1.0
    corrupted_detected: int = 0
    corrected: int = 0
    # closed-loop bookkeeping (repro.serving.controller); all defaulted, so
    # controller-less runs are unaffected
    controller: Optional[str] = None
    windows: int = 0
    adjustments: tuple = ()     # of (window_index, scheme, r, batch_max_size)
    parity_served: int = 0      # parity-pool inference items actually served
    # DES instrumentation: how many discrete events the run processed
    # (arrivals + finishes + control); 0 from the threads engine, which has
    # no event loop.  events / wall-time is the simulator's throughput
    # metric, gated in BENCH_baseline.json.
    events: int = 0
    # multi-tenant breakdown (DESIGN.md §11): tenant name -> {"n", "share",
    # "median_ms", "p999_ms", "slo_ms", "slo_violations"}.  Empty for
    # single-tenant runs; hash=False for the same reason as completed_by.
    per_tenant: Dict[str, dict] = field(default_factory=dict, hash=False)
    # per-token generation metrics (serving/generation.py, DESIGN.md §13):
    # for an LM run a "completion" is ONE decode step of one stream, so
    # median/p999 above ARE inter-token latencies; these fields surface
    # them under their serving-facing names plus the aggregate decode rate.
    # All defaulted — one-shot runs are unaffected.
    tokens_per_s: float = 0.0
    inter_token_p50_ms: float = float("nan")
    inter_token_p999_ms: float = float("nan")
    reconstructed_steps: int = 0

    # -- Mapping protocol: old ``stats()["p999_ms"]`` call sites keep
    # working.  The view is exactly the dataclass fields plus the derived
    # ``cancellations`` total and the three rates — NOT arbitrary
    # attributes, so methods are not "in" the report and ``dict(report)``
    # round-trips every readable key (including the one the examples read
    # as ``stats["cancellations"]``)
    def _key_names(self):
        return [f.name for f in fields(self)] + [
            "cancellations", "straggler_rate", "corruption_rate",
            "cancellation_rate"]

    def __getitem__(self, key):
        if key in self._key_names():
            return getattr(self, key)
        raise KeyError(key)

    def __iter__(self):
        return iter(self._key_names())

    def __len__(self):
        return len(self._key_names())

    @property
    def cancellations(self) -> int:
        """Total redundant work skipped at dequeue, both directions."""
        return self.cancelled_queries + self.cancelled_parities

    # whole-run rates, sharing ReportWindow's empty-window guard: a report
    # over zero completed queries (n == 0) yields 0.0, never a
    # ZeroDivisionError
    @property
    def straggler_rate(self) -> float:
        """Fraction of completions served by a parity reconstruction."""
        return _safe_rate(self.reconstructions, self.n)

    @property
    def corruption_rate(self) -> float:
        return _safe_rate(self.corrupted_detected, self.n)

    @property
    def cancellation_rate(self) -> float:
        return _safe_rate(self.cancellations, self.n)

    def summary(self) -> str:
        """One human-readable line (examples, launchers)."""
        return (
            f"[{self.engine}] {self.strategy}"
            f"{'/' + self.scheme if self.scheme else ''}"
            f" n={self.n} median={self.median_ms:.1f}ms"
            f" p99={self.p99_ms:.1f}ms p99.9={self.p999_ms:.1f}ms"
            f" recon={self.reconstructions} cancelled={self.cancellations}"
            + (f" corrupted={self.corrupted_detected}"
               f"/corrected={self.corrected}"
               if self.corrupted_detected else "")
        )
