"""The port's adaptive-redundancy controllers (``serving/controller.py``)
against the JAX package's, now that ``approxifer`` — the threshold family's
escalation target — is registered in the port.

* The decision policies, fed the same window sequences, make the same
  adjustments and reach the same states.
* The port's DES (``simulate(..., device="cpu")``) gives the same
  ``ServingReport`` — adjustment log, windows and every serving metric — as
  the reference's on the same seeded configs: the static no-op, the bursty
  frontier dominance, the calm run, the spec flow and the trailing-window
  rule.
* The threads engine on ``device="cpu"`` routes escalated groups to the
  deployed-params pools, bypasses a user encoder for them and restores the
  base scheme instance on de-escalation.
* The DES resolves registry names on the device it is given, the
  controller's escalation target included, and asks for the card when it
  is given none.
"""
import math
from dataclasses import fields

import numpy as np
import pytest
import torch

from repro.serving import controller as jctl
from repro.serving import report as jreport
from repro.serving import simulator as jsim
from repro_torch.serving import controller as tctl
from repro_torch.serving import report as treport
from repro_torch.serving import simulator as tsim

PKGS = {"ref": (jctl, jreport), "port": (tctl, treport)}


def _report_equal(got, want):
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), f.name
        else:
            assert a == b, (f.name, a, b)


def _adj(a):
    return None if a is None else (a.scheme, a.r, a.batch_max_size)


# ------------------------------------------------------ decision policies --
def _win(report, n=100, recon=0, corrupted=0, p50=25.0, p999=30.0, index=0):
    return report.ReportWindow(index=index, t0_ms=0.0, t1_ms=1000.0, n=n,
                               p50_ms=p50, p999_ms=p999,
                               reconstructions=recon,
                               corrupted_detected=corrupted)


HOT = dict(p999=100.0)
SEQUENCES = {
    "threshold-escalate-and-return": (
        "threshold", {"down_windows": 1},
        [{}, HOT, {"p999": 50.0}, {}]),
    "threshold-straggler-below": ("threshold", {}, [{"recon": 30}]),
    "threshold-straggler-above": ("threshold", {}, [{"recon": 50}]),
    "threshold-corruption": ("threshold", {}, [{"corrupted": 5}]),
    "threshold-empty-resets-streaks": (
        "threshold", {"down_windows": 2},
        [HOT, {"index": 1}, {"n": 0, "index": 2}, {"index": 3},
         {"index": 4}]),
    "hysteresis-debounce": (
        "hysteresis", {}, [HOT, HOT] + [{"index": i} for i in range(6)]),
    "static-never": ("static", {},
                     [{}, {"p999": 1000.0}, {"n": 0}, {"recon": 100}]),
    "threshold-level-signal": (
        "threshold", {}, [{"p50": 10.0}, {"p50": 40.0, "p999": 60.0},
                          {"p50": 10.0}, {"p50": 10.0}, {"p50": 10.0}]),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_policies_decide_like_reference(case):
    name, kw, seq = SEQUENCES[case]
    logs = {}
    for pkg, (ctl_mod, report) in PKGS.items():
        ctl = ctl_mod.get_controller(name, **kw)
        state = ctl.init(ctl_mod.Adjustment(scheme="sum", r=1,
                                            batch_max_size=1))
        log = []
        for w in seq:
            adj, state = ctl.observe(state, _win(report, **w))
            log.append((_adj(adj), getattr(state, "mode", None)))
        logs[pkg] = log
    assert logs["port"] == logs["ref"]
    if case == "threshold-escalate-and-return":
        assert [a for a, _ in logs["port"]] == [
            None, ("approxifer", 2, 4), None, ("sum", 1, 1)]
    if case == "static-never":
        assert all(a is None for a, _ in logs["port"])


def test_controller_is_functional_and_reusable():
    ctl = tctl.ThresholdController()
    base = tctl.Adjustment(scheme="sum", r=1, batch_max_size=1)
    s1, s2 = ctl.init(base), ctl.init(base)
    adj1, s1 = ctl.observe(s1, _win(treport, p999=100.0))
    adj2, s2 = ctl.observe(s2, _win(treport))
    assert adj1 is not None and adj2 is None
    assert s1.mode == "escalated" and s2.mode == "base"


def test_validation_pool_sizing_and_registry_like_reference():
    with pytest.raises(ValueError, match="not a registered coding scheme"):
        tctl.ThresholdController(escalate_scheme="nope")
    with pytest.raises(ValueError, match="escalate_r"):
        tctl.ThresholdController(escalate_r=0)
    with pytest.raises(ValueError, match="up_windows"):
        tctl.ThresholdController(up_windows=0)
    with pytest.raises(ValueError, match="r must be"):
        tctl.Adjustment(r=0)
    with pytest.raises(ValueError, match="batch_max_size"):
        tctl.Adjustment(batch_max_size=0)
    for name in ("static", "threshold", "hysteresis"):
        t, j = tctl.get_controller(name), jctl.get_controller(name)
        for base_r in (1, 2, 3):
            assert t.max_r(base_r) == j.max_r(base_r)
            assert t.escalation_r(base_r) == j.escalation_r(base_r)
    assert tctl.ThresholdController(escalate_scheme=None,
                                    escalate_r=1).escalation_r(1) == 0
    assert tctl.list_controllers() == jctl.list_controllers()


# ------------------------------------------------------------------ DES ---
def _both(cfg_kw, strategy="parm", **kw):
    """The same seeded run through both DES copies (the port's on the
    CPU); asserts the reports equal and returns the port's."""
    want = jsim.simulate(jsim.SimConfig(**cfg_kw), strategy, **kw)
    got = tsim.simulate(tsim.SimConfig(**cfg_kw), strategy, device="cpu",
                        **kw)
    _report_equal(got, want)
    return got


def test_simulate_runs_on_the_cpu_when_asked():
    """A coded sim run with a registry name, called directly: the scheme
    is resolved on the device the caller gave."""
    rep = _both(dict(n_queries=2000, seed=1), scheme="sum")
    assert rep.reconstructions > 0


def test_simulate_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda is not"):
        tsim.simulate(tsim.SimConfig(n_queries=100), "parm", scheme="sum")
    with pytest.raises(RuntimeError, match="torch.cuda is not"):
        tsim.simulate(tsim.SimConfig(n_queries=2000), "parm", scheme="sum",
                      scenario="bursty", controller="threshold")


def test_escalation_to_approxifer_through_the_des_on_cpu():
    """The threshold controller escalates sum/r=1 to approxifer/r=2 mid
    run: the escalation target is resolved on the CPU, and the adjustment
    log equals the reference's."""
    rep = _both(dict(n_queries=2000), scheme="sum", scenario="bursty",
                controller="threshold")
    assert any(a[1] == "approxifer" for a in rep.adjustments)


def test_static_controller_is_a_noop_through_the_des():
    plain = _both(dict(n_queries=2000), scenario="bursty")
    static = _both(dict(n_queries=2000), scenario="bursty",
                   controller="static")
    assert static.controller == "static" and static.windows > 0
    assert static.adjustments == ()
    for key in ("n", "median_ms", "p99_ms", "p999_ms", "mean_ms", "max_ms",
                "reconstructions", "cancelled_queries", "cancelled_parities",
                "completed_by"):
        assert static[key] == plain[key], key


def test_adaptive_beats_static_frontier_on_bursty_smoke():
    cfg_kw = dict(n_queries=2000)
    adaptive = _both(cfg_kw, scenario="bursty", controller="threshold")
    assert adaptive.adjustments
    grid = {tag: _both(dict(r=r, **cfg_kw), scheme=scheme,
                       scenario="bursty")
            for tag, scheme, r in (("sum_r1", None, 1), ("sum_r2", "sum", 2),
                                   ("apx_r2", "approxifer", 2))}
    for tag, rep in grid.items():
        assert adaptive.p999_ms < rep.p999_ms, tag
    for tag in ("sum_r2", "apx_r2"):
        assert adaptive.parity_served < grid[tag].parity_served, tag


def test_adaptive_controller_stays_quiet_on_calm_workload():
    rep = _both(dict(n_queries=2000), scenario="calm", controller="threshold")
    assert rep.adjustments == () and rep.windows > 0


def test_controller_flows_through_deployment_spec():
    from repro.serving import api as japi
    from repro_torch.serving import api as tapi
    W = np.eye(4, dtype=np.float32)

    def fwd(p, x):
        return x @ p

    kw = dict(fwd=fwd, params=W, parity_params=[W], strategy="parm",
              scheme="sum", k=2, m=2, controller="threshold",
              scenario="bursty")
    trace = dict(n_queries=1000, qps=270.0, seed=0, n_shuffles=0)
    want = japi.deploy(japi.DeploymentSpec(**kw), engine="sim").replay(
        japi.Trace(**trace))
    got = tapi.deploy(tapi.DeploymentSpec(device="cpu", **kw),
                      engine="sim").replay(tapi.Trace(**trace))
    assert got["controller"] == "threshold" and got["windows"] > 0
    _report_equal(got, want)


def test_des_trailing_window_adjustments_are_log_only():
    reps = {}
    for pkg, sim, ctl_mod, scen_mod in (
            ("ref", jsim, jctl, __import__("repro.serving.scenarios",
                                           fromlist=["x"])),
            ("port", tsim, tctl, __import__("repro_torch.serving.scenarios",
                                            fromlist=["x"]))):
        scen = scen_mod.Scenario("trailing-ctl", (
            scen_mod.DeterministicArrivals(
                times_ms=(0.0, 5.0, 10.0, 15.0, 20.0, 25.0)),
            scen_mod.DeterministicSlowdown(targets=(("main", 0),),
                                           add_ms=200.0),
            scen_mod.DeterministicSlowdown(
                targets=(("parity0", 0), ("parity1", 0), ("parity2", 0)),
                add_ms=50.0)))
        cfg = sim.SimConfig(n_queries=6, m=1, k=2, r=1, slo_ms=None,
                            n_shuffles=0)
        kw = {} if pkg == "ref" else {"device": "cpu"}
        plain = sim.simulate(cfg, "parm", scenario=scen, **kw)
        rep = sim.simulate(cfg, "parm", scenario=scen,
                           controller=ctl_mod.ThresholdController(
                               window_ms=300.0), **kw)
        reps[pkg] = (plain, rep)
    _report_equal(reps["port"][0], reps["ref"][0])
    _report_equal(reps["port"][1], reps["ref"][1])
    plain, rep = reps["port"]
    assert rep.windows == 1
    assert tuple(rep.adjustments) == ((0, "approxifer", 2, 4),)
    assert rep.scheme == "approxifer"
    for key in ("n", "median_ms", "p99_ms", "p999_ms", "mean_ms", "max_ms",
                "reconstructions", "cancelled_queries", "cancelled_parities",
                "completed_by", "batches", "mean_batch_size",
                "parity_served"):
        assert rep[key] == plain[key], key


# ------------------------------------------------- threads engine (cpu) ---
def _fwd(p, x):
    return torch.as_tensor(x, device=p.device) @ p


def _escalation_spec(parity_params, *, encode_fn=None, scenario=None,
                     window_ms=1e9):
    from repro_torch.serving.api import DeploymentSpec
    rng = np.random.default_rng(7)
    W = torch.tensor(rng.normal(size=(8, 5)).astype(np.float32))
    spec = DeploymentSpec(
        fwd=_fwd, params=W, parity_params=parity_params(W),
        strategy="parm", scheme="sum", k=2, r=1, m=2, scenario=scenario,
        encode_fn=encode_fn, device="cpu",
        controller=tctl.ThresholdController(window_ms=window_ms,
                                            escalate_batch_max=1))
    return spec, W


def test_escalated_groups_route_to_deployed_params_pools():
    """The trained parity model is -W, wrong for any other code: escalated
    approxifer groups must run on the deployed-params pools, and with both
    mains stalled every answer is an exact approxifer reconstruction."""
    from repro_torch.serving.api import deploy
    from repro_torch.serving.scenarios import (DeterministicSlowdown,
                                               Scenario, pool_of_iid)
    scen = Scenario("esc-route", (DeterministicSlowdown(
        targets=(("main", 0), ("main", 1)), add_ms=60_000.0),))
    spec, W = _escalation_spec(lambda W: [-W], scenario=scen)
    sess = deploy(spec, engine="threads")
    try:
        fe = sess.frontend
        assert fe._agn_base == 1 and fe._agn_r == 2
        assert len(fe.parity_qs) == 3
        for w in fe.workers:
            pool, _ = pool_of_iid(w.iid)
            if pool == "parity0":
                assert torch.equal(w.params, -W)
            elif pool.startswith("parity"):
                assert w.params is spec.params and w.fwd is spec.fwd
        with fe.lock:
            fe._apply_adjustment(
                tctl.Adjustment(scheme="approxifer", r=2, batch_max_size=1),
                0)
        assert fe.scheme.name == "approxifer" and fe.scheme.device == "cpu"
        rng = np.random.default_rng(1)
        for _ in range(2):
            sess.submit(rng.normal(size=(1, 8)).astype(np.float32))
        assert sess.wait_all(timeout=60)
        warm = sess.stats()["reconstructions"]
        xs = [rng.normal(size=(1, 8)).astype(np.float32) for _ in range(2)]
        futs = [sess.submit(x) for x in xs]
        assert sess.wait_all(timeout=60)
        for f, x in zip(futs, xs):
            np.testing.assert_allclose(np.asarray(f.result(timeout=1.0)),
                                       x @ W.numpy(), rtol=1e-4, atol=1e-4)
        assert sess.stats()["reconstructions"] >= warm + 1
    finally:
        sess.shutdown()


def test_user_encode_fn_is_bypassed_for_escalated_groups():
    from repro_torch.core.scheme import get_scheme
    from repro_torch.serving.api import deploy
    calls = []
    sum_code = get_scheme("sum", k=2, r=1, device="cpu")

    def counting_encode(stacked):
        calls.append(1)
        return sum_code.encode(stacked)

    spec, _ = _escalation_spec(lambda W: [W], encode_fn=counting_encode)
    sess = deploy(spec, engine="threads")
    try:
        fe = sess.frontend
        x = np.ones((1, 8), np.float32)
        for _ in range(2):
            sess.submit(x)
        assert len(calls) == 1
        with fe.lock:
            fe._apply_adjustment(
                tctl.Adjustment(scheme="approxifer", r=2, batch_max_size=1),
                0)
        for _ in range(2):
            sess.submit(x)
        assert len(calls) == 1
        with fe.lock:
            fe._apply_adjustment(tctl.Adjustment(scheme="sum", r=1), 1)
        for _ in range(2):
            sess.submit(x)
        assert len(calls) == 2
        assert sess.wait_all(timeout=20)
    finally:
        sess.shutdown()


def test_adjustment_restores_base_scheme_instance_and_validates_target():
    from repro_torch.serving.api import deploy
    spec, _ = _escalation_spec(lambda W: [W])
    sess = deploy(spec, engine="threads")
    try:
        fe = sess.frontend
        base = fe.scheme
        assert fe._base_scheme is base
        with fe.lock:
            fe._apply_adjustment(tctl.Adjustment(scheme="approxifer", r=2), 0)
        assert fe.scheme is not base and fe.r == 2
        assert fe.scheme.name == "approxifer"
        with fe.lock:
            fe._apply_adjustment(tctl.Adjustment(scheme="sum", r=1), 1)
        assert fe.scheme is base
        with pytest.raises(ValueError, match="model_agnostic"):
            with fe.lock:
                fe._apply_adjustment(tctl.Adjustment(scheme="sum", r=2), 2)
        with pytest.raises(ValueError, match="escalation pools"):
            with fe.lock:
                fe._apply_adjustment(
                    tctl.Adjustment(scheme="approxifer", r=3), 2)
    finally:
        sess.shutdown()
