"""The port's DES keeps the reference's fast-path promise: on every
configuration class eligible for the inlined fast loop, the fast loop and
the general event loop give bit-identical reports (the twin of
``tests/test_sim_workloads.py``'s fast-path tests, run on
``repro_torch.serving.simulator`` with ``device="cpu"``)."""
import pytest

import repro_torch.serving.simulator as sim_mod
from repro_torch.serving.simulator import SimConfig, simulate


@pytest.fixture
def force_path():
    """Run simulate() with the fast/general path forced, restoring
    auto-selection afterwards."""
    def run(path, cfg, **kw):
        sim_mod._FORCE_PATH = path
        try:
            return simulate(cfg, device="cpu", **kw)
        finally:
            sim_mod._FORCE_PATH = None
    return run


def _key(rep):
    """Every observable a fast/general divergence could leak through."""
    return (rep.median_ms, rep.p99_ms, rep.p999_ms, rep.mean_ms, rep.max_ms,
            rep.reconstructions, rep.cancelled_queries,
            rep.cancelled_parities, rep.batches, rep.parity_served,
            rep.events, tuple(sorted(rep.completed_by.items())))


FAST_CASES = [
    dict(strategy="parm", scheme="sum", scenario="calm"),
    dict(strategy="parm", scheme="sum", scenario="diurnal"),
    dict(strategy="parm", scheme="sum", scenario="flash_crowd"),
    dict(strategy="parm", scheme="replication", scenario="calm"),
    dict(strategy="parm", scheme="approxifer", scenario="calm"),
    dict(strategy="approx_backup", scenario="calm"),
    dict(strategy="equal_resources", scheme="sum", scenario="calm"),
    dict(strategy="none", scenario="calm"),
]


@pytest.mark.parametrize("case", FAST_CASES,
                         ids=lambda c: f"{c['strategy']}-"
                                       f"{c.get('scheme')}-{c['scenario']}")
def test_fast_path_bit_equal_to_general_loop(case, force_path):
    """Identical RNG draw order, dispatch order and float arithmetic on
    both loops; _FORCE_PATH='fast' raises if the config fell off the fast
    path, so eligibility is pinned too."""
    cfg = SimConfig(n_queries=6000, seed=3)
    fast = force_path("fast", cfg, **case)
    general = force_path("general", cfg, **case)
    assert _key(fast) == _key(general)


def test_hazard_scenarios_are_not_fast_eligible(force_path):
    """bursty carries NetworkShuffles: it must take the general loop."""
    cfg = SimConfig(n_queries=2000, seed=1)
    with pytest.raises(ValueError, match="not eligible"):
        force_path("fast", cfg, strategy="parm", scenario="bursty")


@pytest.mark.parametrize("strategy", ["parm", "none"])
def test_event_count_identity(strategy):
    """events = arrivals + finish pops: n + main batches + parity items
    served on a hazard-free run with no controller."""
    rep = simulate(SimConfig(n_queries=4000, seed=1), strategy,
                   scenario="calm", device="cpu")
    assert rep.events == rep.n + rep.batches + rep.parity_served
