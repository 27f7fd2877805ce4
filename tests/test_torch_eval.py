"""The second slice of the port as a whole: the scheme registry's accuracy
evaluation (``eval/unavailability.py``) and ``approxifer`` served under
Byzantine faults, against the JAX package.

A small deployed MLP is trained in JAX on the resnet18_cifar task family at
a CPU-sized image (8x8x3, n=240, one epoch) and carried across with
``params_from_numpy``.  Then:

* for the training-free schemes (approxifer, fisher, invnet; invnet with the
  reference's couplings carried across) both packages provision from the
  shared deployed params, their parity outputs agree within 1e-4 and
  ``_degraded`` gives exactly the same A_d, on both backends of the port;
* ``_served_under_errors`` for approxifer at r=2 serves the same predictions
  (argmax equal, values within 1e-4) on the same error realization;
* the trained schemes (sum, concat, learned, approx_backup) cannot match
  the reference after training from different random draws: they run end
  to end on ``device="cpu"`` and give accuracies in [0, 1];
* the sim engine's seeded ``ServingReport`` for approxifer (k=2, r=2) under
  the ``byzantine`` scenario equals the reference's field for field, and the
  two deterministic Byzantine cases of the reference's differential battery
  give the same detected / corrected / reconstruction counts on the port's
  threads engine and DES (``device="cpu"``) as on the reference's DES.
"""
import math
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parity as jparity
from repro.data.pipeline import cluster_images
from repro.eval import unavailability as jeval
from repro.models import cnn as jcnn
from repro.serving import api as japi
from repro.serving import scenarios as jscen
from repro_torch.convert import params_from_numpy, to_host
from repro_torch.core import parity as tparity
from repro_torch.core import scheme as tscheme
from repro_torch.eval import unavailability as teval
from repro_torch.models import cnn as tcnn
from repro_torch.serving import api as tapi
from repro_torch.serving import scenarios as tscen

IMG = (8, 8, 3)
K = 2
V = 10
SMALL = dict(model="mlp", image_shape=IMG, n_train=200, n_test=60,
             noise=0.8, deployed_epochs=1, parity_epochs=1, seed=0,
             device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def system():
    x, y, tmpl = cluster_images(240, noise=0.8, seed=0, image_shape=IMG)
    xt, yt, _ = cluster_images(120, noise=0.8, seed=1, templates=tmpl,
                               image_shape=IMG)
    params, fwd = jeval._train_deployed(x, y, "mlp", IMG, V, 1, 0)
    return dict(x=x, xt=xt, yt=yt, params=params, fwd=fwd,
                tparams=params_from_numpy(_np(params), "cpu"))


def _provision_both(system, name, r, backend):
    """The reference's provisioning of ``name`` and the port's from the
    shared deployed params; invnet's couplings are carried across."""
    def j_init(key):
        return jcnn.build("mlp", key, image_shape=IMG)[0]

    def t_init(seed):
        return tcnn.build("mlp", seed, image_shape=IMG, device="cpu")[0]

    jpp, jsch = jparity.train_parity_models(
        system["params"], system["fwd"], j_init, system["x"], k=K, r=r,
        scheme=name, epochs=1, seed=0)
    tsch = tscheme.get_scheme(name, k=K, r=r, backend=backend, device="cpu")
    if name == "invnet":
        tsch = tsch.with_params(params_from_numpy(
            _np(jsch.coupling_params), "cpu"))
    tpp, tsch = tparity.train_parity_models(
        system["tparams"], tcnn.mlp_fwd, t_init, system["x"], k=K,
        scheme=tsch, epochs=1, seed=0, device="cpu")
    return (jsch, jpp), (tsch, tpp)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("name", ["approxifer", "fisher", "invnet"])
def test_training_free_schemes_a_d_equals_reference(system, name, backend):
    (jsch, jpp), (tsch, tpp) = _provision_both(system, name, 1, backend)
    xt, yt = system["xt"], system["yt"]
    j_member = np.asarray(system["fwd"](system["params"], jnp.asarray(
        xt))).reshape(-1, K, V)
    groups = xt.reshape(-1, K, *IMG)
    j_pouts = np.moveaxis(np.asarray(jparity.fused_parity_outputs(
        jsch, jnp.asarray(np.moveaxis(groups, 1, 0)), jpp, system["fwd"])),
        0, 1)
    t_member, t_pouts = teval._outputs(tsch, tpp, tcnn.mlp_fwd,
                                       system["tparams"], tcnn.mlp_fwd, xt,
                                       V)
    np.testing.assert_allclose(to_host(t_member), j_member, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(to_host(t_pouts), j_pouts, atol=1e-4,
                               rtol=1e-4)
    want = jeval._degraded(jsch, jpp, system["fwd"], system["params"],
                           system["fwd"], xt, yt, V)
    got = teval._degraded(tsch, tpp, tcnn.mlp_fwd, system["tparams"],
                          tcnn.mlp_fwd, xt, yt, V)
    assert got == want
    assert 0.0 < got <= 1.0


def test_served_under_errors_equals_reference(system):
    """approxifer at r=2 on the same outputs and the same corruption mask:
    the same groups are voted and re-decoded, the same predictions
    served."""
    (jsch, jpp), (tsch, _) = _provision_both(system, "approxifer", 2,
                                             "kernels")
    xt, yt = system["xt"], system["yt"]
    member = np.asarray(system["fwd"](system["params"], jnp.asarray(
        xt))).reshape(-1, K, V)
    groups = xt.reshape(-1, K, *IMG)
    pouts = np.moveaxis(np.asarray(jparity.fused_parity_outputs(
        jsch, jnp.asarray(np.moveaxis(groups, 1, 0)), jpp, system["fwd"])),
        0, 1)
    glabels = yt.reshape(-1, K)
    for rate in (0.0, 0.1, 0.25):
        corrupt = np.random.default_rng(int(rate * 1000)).random(
            member.shape[:2]) < rate
        want = jeval._served_under_errors(jsch, member, pouts, corrupt)
        got = teval._served_under_errors(tsch, member, pouts, corrupt)
        np.testing.assert_array_equal(np.argmax(got, -1),
                                      np.argmax(want, -1))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert (np.argmax(got, -1) == glabels).mean() > 0.0
    # the sum code has no vote: it serves the garbage as-is
    ssum = tscheme.get_scheme("sum", k=K, r=2, device="cpu")
    served = teval._served_under_errors(ssum, member, pouts, corrupt)
    assert (served[corrupt] == tscen.CORRUPTION_SCALE).all()


def test_accuracy_under_errors_runs_on_cpu():
    res = teval.accuracy_under_errors(schemes=("sum", "approxifer"),
                                      error_rates=(0.0, 0.25), **SMALL)
    s, a = res["schemes"]["sum"], res["schemes"]["approxifer"]
    assert s[0.0] == a[0.0]                 # identical clean predictions
    assert a[0.25] >= s[0.25]
    assert 0.0 <= res["A_a"] <= 1.0


def test_trained_schemes_run_on_cpu_and_report_accuracies():
    provisioned = {}
    names = ("sum", "concat", "learned", "approx_backup")
    res = teval.accuracy_under_unavailability(schemes=names,
                                              provisioned=provisioned,
                                              **SMALL)
    assert set(res["schemes"]) == set(names)
    assert 0.0 <= res["A_a"] <= 1.0
    for name in names:
        assert 0.0 <= res["schemes"][name] <= 1.0
        scheme, pp, _ = provisioned[name]
        assert scheme.name == name and scheme.device == "cpu"
        assert len(pp) == scheme.r
    # the learned scheme that scores is the jointly trained one
    assert float(provisioned["learned"][0].enc_params["alpha"]) != 0.0
    assert provisioned["test"][0].shape[1:] == IMG


def test_eval_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda is not"):
        teval.accuracy_under_unavailability(schemes=("sum",), n_train=8,
                                            n_test=4)
    with pytest.raises(RuntimeError, match="torch.cuda is not"):
        teval.accuracy_under_errors(schemes=("sum",), n_train=8, n_test=4)


# ------------------------------------------------- Byzantine serving -----
def _report_equal(got, want):
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), f.name
        else:
            assert a == b, (f.name, a, b)


def test_sim_engine_approxifer_byzantine_report_equals_reference():
    kw = dict(strategy="parm", scheme="approxifer", k=K, r=2, m=12,
              scenario="byzantine")
    trace = dict(n_queries=4000, qps=270.0, seed=3)
    want = japi.deploy(japi.DeploymentSpec(**kw), engine="sim").replay(
        japi.Trace(**trace))
    got = tapi.deploy(tapi.DeploymentSpec(device="cpu", **kw),
                      engine="sim").replay(tapi.Trace(**trace))
    assert want.corrupted_detected > 0 and want.corrected > 0
    _report_equal(got, want)


def _torch_linear(p, x):
    return torch.as_tensor(x, device=p.device) @ p


def _jax_linear(p, x):
    return x @ p


MEMBER_MS = 700.0


def _byzantine_scenario(scen, late):
    """The reference's two deterministic Byzantine orderings, built from
    one package's scenario classes: the corrupt member arrives after the
    two extra responses (``late=False``: voted out and corrected) or
    before them (``late=True``: detected too late to correct)."""
    if late:
        return scen.Scenario("diff-byzantine-late", (
            scen.DeterministicCorruption(targets=(("main", 1),),
                                         add_ms=30.0),
            scen.DeterministicSlowdown(targets=(("main", 0),), add_ms=30.0),
            scen.DeterministicSlowdown(
                targets=(("parity0", 0), ("parity1", 0)), add_ms=500.0)))
    return scen.Scenario("diff-byzantine", (
        scen.DeterministicCorruption(targets=(("main", 1),),
                                     add_ms=MEMBER_MS),
        scen.DeterministicSlowdown(targets=(("main", 0),), add_ms=50.0),
        scen.DeterministicSlowdown(targets=(("parity0", 0), ("parity1", 0)),
                                   add_ms=300.0)))


def _sim(api, spec):
    return api.deploy(spec, engine="sim").replay(
        api.Trace(n_queries=2, qps=1000.0, seed=0, n_shuffles=0))


@pytest.mark.parametrize("late", [False, True])
def test_byzantine_cases_on_the_threads_engine(late):
    import time
    rng = np.random.default_rng(0)
    W = rng.normal(size=(8, 5)).astype(np.float32)
    jspec = japi.DeploymentSpec(
        fwd=_jax_linear, params=jnp.asarray(W), parity_params=[W, W],
        strategy="parm", scheme="approxifer", k=K, r=2, m=K,
        scenario=_byzantine_scenario(jscen, late))
    tW = params_from_numpy(W, "cpu")
    tspec = tapi.DeploymentSpec(
        fwd=_torch_linear, params=tW, parity_params=[tW, tW],
        strategy="parm", scheme="approxifer", k=K, r=2, m=K,
        scenario=_byzantine_scenario(tscen, late), device="cpu")
    ref_sim, port_sim = _sim(japi, jspec), _sim(tapi, tspec)
    _report_equal(port_sim, ref_sim)
    sess = tapi.deploy(tspec, engine="threads")
    try:
        sess.frontend.encode_fn(np.zeros((K, 1, 8), np.float32))   # warm
        xs = [rng.normal(size=(1, 8)).astype(np.float32) for _ in range(K)]
        futs = [sess.submit(x) for x in xs]
        assert sess.wait_all(timeout=30)
        if late:
            # answered with the garbage long before the extra responses
            # land and the re-vote fires: poll, don't sleep
            deadline = time.time() + 15.0
            while sess.stats()["corrupted_detected"] == 0 and \
                    time.time() < deadline:
                time.sleep(0.02)
        else:
            for f, x in zip(futs, xs):
                np.testing.assert_allclose(np.asarray(f.result(1.0)), x @ W,
                                           atol=1e-2)
    finally:
        sess.shutdown()
    rt = sess.stats()
    want = (1, 0, 0, {"model": 2}) if late else \
        (1, 1, 1, {"model": 1, "parity": 1})
    for rep in (rt, port_sim, ref_sim):
        assert (rep["corrupted_detected"], rep["corrected"],
                rep["reconstructions"], rep["completed_by"]) == want, rep
