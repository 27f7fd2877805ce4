"""The first slice of the port as a whole: coded MLP serving with the ``sum``
code at k=2, against the JAX package on the same data and parameters.

A tiny deployed MLP and its parity model are trained in JAX (16x16x1 images,
n=300, one epoch) and carried across with ``params_from_numpy``.  Then:

* provisioning (``train_parity_models``) from identical deployed params and
  identical parity init ends within 1e-4 of the JAX parity params;
* ``fused_parity_outputs`` (fused and ``_FORCE_FUSED=False``, both backends)
  agrees within 1e-4 and ``degraded_accuracy`` gives exactly the same A_d;
* the sim engine's ``ServingReport`` equals ``repro``'s field for field on
  the same seeded ``DeploymentSpec`` for parm/sum, replication and
  approx_backup;
* the threads engine on ``device="cpu"`` with a straggling instance answers
  every query, reconstructs through parity, and its reconstructions equal the
  reference ``decode_one`` on the same outputs; on a deterministic slowdown
  pattern both packages' threads engines make the same number of
  reconstructions and cancellations, in the manner of
  ``tests/test_differential.py``.
"""
import math
import time
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import parity as jparity
from repro.data.pipeline import batched, cluster_images
from repro.models import cnn as jcnn
from repro.serving import api as japi
from repro.serving import scenarios as jscen
from repro.training.loss import softmax_xent
from repro.training.optim import AdamConfig, adam_init, adam_update
from repro_torch.convert import params_from_numpy, params_to_numpy, to_host
from repro_torch.core import metrics as tmetrics
from repro_torch.core import parity as tparity
from repro_torch.core.scheme import get_scheme as t_get_scheme
from repro_torch.models import cnn as tcnn
from repro_torch.serving import api as tapi
from repro_torch.serving import scenarios as tscen

IMG = (16, 16, 1)
K = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def system():
    x, y, tmpl = cluster_images(300, noise=1.5, seed=0, image_shape=IMG)
    xt, yt, _ = cluster_images(200, noise=1.5, seed=1, templates=tmpl,
                               image_shape=IMG)
    params, fwd = jcnn.build("mlp", jax.random.PRNGKey(0), image_shape=IMG)
    opt = AdamConfig(lr=1e-3)
    st = adam_init(params, opt)

    @jax.jit
    def step(p, s, xb, yb):
        _, g = jax.value_and_grad(lambda p: softmax_xent(fwd(p, xb), yb))(p)
        return adam_update(g, s, p, opt)

    for xb, yb in batched(x, y, 64, epochs=1):
        params, st = step(params, st, xb, yb)
    init_np = _np(jcnn.build("mlp", jax.random.PRNGKey(9),
                             image_shape=IMG)[0])
    pp, _ = jparity.train_parity_models(
        params, fwd, lambda key: jax.tree.map(jnp.asarray, init_np), x, k=K,
        epochs=1, seed=0)
    return dict(x=x, xt=xt, yt=yt, params=params, pp=pp, init_np=init_np,
                tparams=params_from_numpy(_np(params), "cpu"),
                tpp=[params_from_numpy(_np(p), "cpu") for p in pp])


def _close_trees(got, want, atol):
    g, w = jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=atol)


def test_train_parity_models_matches_reference(system):
    """Provisioning from identical deployed params and parity init: same
    dataset (bit-equal numpy), same batches, parity params within 1e-4."""
    init_np = system["init_np"]
    tpp, scheme = tparity.train_parity_models(
        system["tparams"], tcnn.mlp_fwd,
        lambda seed: params_from_numpy(init_np, "cpu"), system["x"], k=K,
        epochs=1, seed=0, device="cpu")
    assert scheme.name == "sum" and scheme.device == "cpu" and len(tpp) == 1
    _close_trees(tpp[0], system["pp"][0], 1e-4)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("force", [None, False])
def test_fused_parity_outputs_and_degraded_accuracy(system, backend, force):
    xt, yt = system["xt"], system["yt"]
    G = len(xt) // K
    groups = xt.reshape(G, K, *IMG)
    glabels = yt.reshape(G, K)
    jscheme = jparity.get_scheme("sum", k=K)
    tscheme = t_get_scheme("sum", k=K, backend=backend, device="cpu")
    want = np.asarray(jparity.fused_parity_outputs(
        jscheme, jnp.asarray(np.moveaxis(groups, 1, 0)), system["pp"],
        jcnn.mlp_fwd))
    tparity._FORCE_FUSED = force
    try:
        got = to_host(tparity.fused_parity_outputs(
            tscheme, np.moveaxis(groups, 1, 0), system["tpp"],
            tcnn.mlp_fwd))
    finally:
        tparity._FORCE_FUSED = None
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jmember = np.asarray(jcnn.mlp_fwd(system["params"], jnp.asarray(
        groups.reshape(G * K, *IMG)))).reshape(G, K, 10)
    tmember = to_host(tcnn.mlp_fwd(system["tparams"],
                                   groups.reshape(G * K, *IMG))).reshape(
        G, K, 10)
    np.testing.assert_allclose(tmember, jmember, atol=1e-4, rtol=1e-4)
    a_d_ref = jmetrics.degraded_accuracy(np.moveaxis(want, 0, 1), jmember,
                                         glabels, jscheme)
    a_d = tmetrics.degraded_accuracy(np.moveaxis(got, 0, 1), tmember,
                                     glabels, tscheme)
    assert a_d == a_d_ref
    assert a_d > 0.1


def test_fused_parity_outputs_force_raises_when_not_fusable(system):
    tscheme = t_get_scheme("sum", k=K, device="cpu")
    q = np.zeros((K, 3) + IMG, np.float32)

    def custom_fwd(p, x):                   # MLP-shaped but not mlp_fwd
        return tcnn.mlp_fwd(p, x)

    tparity._FORCE_FUSED = True
    try:
        with pytest.raises(ValueError, match="not fusable"):
            tparity.fused_parity_outputs(tscheme, q, system["tpp"],
                                         custom_fwd)
    finally:
        tparity._FORCE_FUSED = None


def _report_equal(got, want):
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), f.name
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("strategy,scheme", [
    ("parm", "sum"), ("replication", None), ("approx_backup", None)])
def test_sim_engine_report_equals_reference(strategy, scheme):
    kw = dict(strategy=strategy, scheme=scheme, k=K, m=12,
              batching=japi.BatchingPolicy(max_size=2))
    trace = dict(n_queries=4000, qps=270.0, seed=3)
    want = japi.deploy(japi.DeploymentSpec(**kw), engine="sim").replay(
        japi.Trace(**trace))
    kw["batching"] = tapi.BatchingPolicy(max_size=2)
    got = tapi.deploy(tapi.DeploymentSpec(device="cpu", **kw),
                      engine="sim").replay(tapi.Trace(**trace))
    assert [f.name for f in fields(got)] == [f.name for f in fields(want)]
    assert want.reconstructions > 0 or strategy != "parm"
    _report_equal(got, want)


def test_threads_engine_reconstructs_like_reference_decode(system):
    """Trained MLP + parity model on the CPU, one straggling instance: every
    query answered, some through parity, each reconstruction equal to the
    reference's decode_one on the same member and parity outputs."""
    xt = system["xt"]
    n = 12

    def straggle(iid):
        return 0.4 if iid == 0 else 0.0

    spec = tapi.DeploymentSpec(
        fwd=tcnn.mlp_fwd, params=system["tparams"],
        parity_params=system["tpp"][0], strategy="parm", scheme="sum", k=K,
        m=4, delay_fn=straggle, device="cpu")
    with tapi.deploy(spec, engine="threads") as sess:
        futs = []
        for i in range(n):
            futs.append(sess.submit(xt[i:i + 1]))
            time.sleep(0.02)
        assert sess.wait_all(timeout=30)
        stats = sess.stats()
    assert sum(stats.completed_by.values()) == n
    assert stats.completed_by.get("parity", 0) > 0
    assert stats.reconstructions == stats.completed_by["parity"]
    jscheme = jparity.get_scheme("sum", k=K)
    jfwd = jax.jit(jcnn.mlp_fwd)
    for f in futs:
        out = np.asarray(f.result())
        assert out.shape == (1, 10) and np.isfinite(out).all()
        g, j = divmod(f.qid, K)
        xs = xt[g * K:(g + 1) * K]
        if f.completed_by == "model":
            want = np.asarray(jfwd(system["params"], xs[j:j + 1]))
        else:
            po = np.asarray(jfwd(system["pp"][0], xs.sum(0, keepdims=True)))
            outs = np.stack([np.asarray(jfwd(system["params"], xs[i:i + 1]))
                             for i in range(K)])
            outs[j] = 0.0                     # the straggler's slot
            want = np.asarray(jscheme.decode_one(po, outs, j))
        np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)


def _jax_linear(p, x):
    return x @ p


def _torch_linear(p, x):
    return torch.as_tensor(x, device=p.device) @ p


def _pattern(scen, k, slow_main):
    """test_differential's deterministic unavailability pattern, built from
    one package's scenario classes."""
    slow = tuple(("main", s) for s in slow_main)
    base = tuple(("main", s) for s in range(k) if s not in slow_main)
    return scen.Scenario("diff-pattern", (
        scen.DeterministicSlowdown(targets=slow, add_ms=700.0),
        scen.DeterministicSlowdown(targets=base, add_ms=300.0),
        scen.DeterministicSlowdown(
            targets=tuple((f"parity{j}", 0) for j in range(4)),
            add_ms=100.0)))


@pytest.mark.parametrize("scheme,r,slow_main", [("sum", 1, (0,)),
                                                ("sum", 2, (0, 1)),
                                                ("replication", None, (1,))])
def test_threads_engine_counts_match_reference(scheme, r, slow_main):
    rng = np.random.default_rng(0)
    W = rng.normal(size=(8, 5)).astype(np.float32)
    xs = [rng.normal(size=(1, 8)).astype(np.float32) for _ in range(K)]
    pp = None if scheme == "replication" else [W] * (r or 1)
    reports = {}
    for name, api, scen, params in (
            ("ref", japi, jscen, jnp.asarray(W)),
            ("port", tapi, tscen, params_from_numpy(W, "cpu"))):
        if name == "ref":
            kw, fwd = {}, _jax_linear
        else:
            kw, fwd = {"device": "cpu"}, _torch_linear
        spec = api.DeploymentSpec(
            fwd=fwd, params=params,
            parity_params=None if pp is None else [params] * len(pp),
            strategy="parm", scheme=scheme, k=K, r=r, m=K,
            scenario=_pattern(scen, K, slow_main), **kw)
        sess = api.deploy(spec, engine="threads")
        try:
            fe = sess.frontend
            fe.encode_fn(np.zeros((fe.group_k, 1, 8), np.float32))   # warm
            futs = [sess.submit(x) for x in xs]
            assert sess.wait_all(timeout=30)
            for f, x in zip(futs, xs):
                np.testing.assert_allclose(np.asarray(f.result(1.0)), x @ W,
                                           atol=1e-4)
        finally:
            sess.shutdown()
        reports[name] = sess.stats()
    ref, port = reports["ref"], reports["port"]
    assert port.reconstructions == ref.reconstructions > 0
    assert port.completed_by == ref.completed_by
    assert port.cancelled_queries == ref.cancelled_queries
    assert port.cancelled_parities == ref.cancelled_parities
