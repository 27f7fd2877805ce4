"""The port's models, losses, optimizer and parity trainer against the JAX
package's, on parameters carried across with ``convert.params_from_numpy``
(the two packages' random initialisers differ, so every comparison starts
from the same numpy leaves).  Forward passes agree within atol 1e-4 (fp32,
different reduction orders); one Adam step and three parity-trainer steps
from identical init and batches end within 1e-4 of the JAX parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parity as jparity
from repro.models import cnn as jcnn
from repro.models import linear as jlinear
from repro.training import loss as jloss
from repro.training import optim as joptim
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 tree_leaves, tree_map)
from repro_torch.core import parity as tparity
from repro_torch.models import cnn as tcnn
from repro_torch.models import linear as tlinear
from repro_torch.training import loss as tloss
from repro_torch.training import optim as toptim


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want, atol):
    g, w = tree_leaves(params_to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=atol,
                                   rtol=atol)


def _shapes(kind, image_shape):
    """The JAX model's parameter tree as ShapeDtypeStructs."""
    key = jax.random.PRNGKey(0)
    if kind == "mlp":        # build() sizes the input with a traced jnp.prod
        return jax.eval_shape(
            lambda: jcnn.init_mlp(key, int(np.prod(image_shape))))
    return jax.eval_shape(
        lambda: jcnn.build(kind, key, image_shape=image_shape)[0])


def _random_params(kind, image_shape, rng):
    """The JAX model's parameter tree (shapes from ``eval_shape``, so JAX's
    initialiser never runs) filled with fan-in-scaled numpy normals."""
    shapes = _shapes(kind, image_shape)

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 100
        return jnp.asarray(rng.normal(size=s.shape).astype(np.float32)
                           / np.sqrt(fan_in))
    return jax.tree.map(fill, shapes)


@pytest.mark.parametrize("kind,image_shape", [
    ("mlp", (8, 8, 1)), ("mlp", (28, 28, 1)), ("lenet", (8, 8, 2)),
    ("resnet", (10, 10, 2)),
])
def test_forward_matches_reference(kind, image_shape):
    jp = _random_params(kind, image_shape, np.random.default_rng(3))
    jfwd = jcnn.MODEL_FNS[kind][1]
    tp = params_from_numpy(_np(jp), device="cpu")
    tfwd = tcnn.MODEL_FNS[kind][1]
    x = np.random.default_rng(0).normal(size=(3,) + image_shape).astype(
        np.float32)
    want = np.asarray(jax.jit(jfwd)(jp, jnp.asarray(x)))
    got = tfwd(tp, x)                       # numpy input moves to the device
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-4)
    # the tree round-trips leaf for leaf
    _close_trees(tp, jp, 0)


def test_build_layouts_match_reference():
    """Same tree structure and leaf shapes as the JAX package's models."""
    for kind in ("mlp", "lenet", "resnet"):
        jp = _shapes(kind, (8, 8, 3))
        tp, _ = tcnn.build(kind, 0, image_shape=(8, 8, 3), device="cpu")
        assert jax.tree.structure(jp) == jax.tree.structure(
            params_to_numpy(tp)), kind
        assert [a.shape for a in jax.tree.leaves(jp)] == \
            [tuple(t.shape) for t in tree_leaves(tp)]
    jl = jlinear.init_linear(jax.random.PRNGKey(0), 12, 5)
    tl = tlinear.init_linear(0, 12, 5, device="cpu")
    x = np.ones((2, 3, 4), np.float32)
    np.testing.assert_allclose(
        tlinear.linear_fwd(params_from_numpy(_np(jl), "cpu"), x).numpy(),
        np.asarray(jlinear.linear_fwd(jl, jnp.asarray(x))), atol=1e-5)
    assert tuple(tl["w"].shape) == (12, 5)


def test_losses_match_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=6).astype(np.int32)
    mask = (rng.random(6) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(tloss.softmax_xent(torch.tensor(logits), labels)),
        float(jloss.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss.softmax_xent(torch.tensor(logits), labels,
                                 torch.tensor(mask))),
        float(jloss.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(mask))), rtol=1e-6)
    t = rng.normal(size=(6, 10)).astype(np.float32)
    np.testing.assert_allclose(
        float(tloss.parity_mse(torch.tensor(logits), torch.tensor(t))),
        float(jloss.parity_mse(jnp.asarray(logits), jnp.asarray(t))),
        rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adam_update_matches_reference(moment_dtype):
    """One step (and a second, for the bias correction) with decoupled
    weight decay and an active global-norm clip."""
    cfg_kw = dict(lr=1e-2, weight_decay=1e-2, grad_clip=0.5,
                  moment_dtype=moment_dtype)
    jcfg, tcfg = joptim.AdamConfig(**cfg_kw), toptim.AdamConfig(**cfg_kw)
    rng = np.random.default_rng(2)
    p = {"w": [rng.normal(size=(5, 4)).astype(np.float32),
               rng.normal(size=(4, 3)).astype(np.float32)],
         "b": [rng.normal(size=(4,)).astype(np.float32),
               np.zeros(3, np.float32)]}
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    js, ts = joptim.adam_init(jp, jcfg), toptim.adam_init(tp, tcfg)
    for step in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * 3.0, p)
        jp, js = joptim.adam_update(jax.tree.map(jnp.asarray, g), js, jp,
                                    jcfg)
        tp, ts = toptim.adam_update(params_from_numpy(g, "cpu"), ts, tp, tcfg)
        assert ts["step"] == int(js["step"]) == step + 1
        _close_trees(tp, jp, 1e-6)
        _close_trees(ts["mu"], js["mu"], 1e-6)
        _close_trees(ts["nu"], js["nu"], 1e-6)
    assert float(toptim.global_norm(tp)) == pytest.approx(
        float(joptim.global_norm(jp)), rel=1e-6)


def test_parity_trainer_three_steps_match_reference():
    """ParityTrainer from identical init on identical batches: 3 steps."""
    k, n_groups, batch = 2, 3 * 16, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n_groups * k, 6, 6, 1)).astype(np.float32)
    jp0 = jcnn.init_mlp(jax.random.PRNGKey(1), 36, hidden=(32, 16), n_out=10)
    fx = np.asarray(jcnn.mlp_fwd(jp0, jnp.asarray(x)))
    jscheme = jparity.get_scheme("sum", k=k)
    tscheme_ = tparity.get_scheme("sum", k=k, device="cpu")
    jpq, jtg = jparity.make_parity_dataset(x, fx, k, jscheme, 0,
                                           np.random.default_rng(0))
    tpq, ttg = tparity.make_parity_dataset(x, fx, k, tscheme_, 0,
                                           np.random.default_rng(0))
    np.testing.assert_array_equal(tpq, jpq)
    np.testing.assert_array_equal(ttg, jtg)
    init = jcnn.init_mlp(jax.random.PRNGKey(4), 36, hidden=(32, 16), n_out=10)
    tinit = params_from_numpy(_np(init), "cpu")
    jout, jl = jparity.ParityTrainer(fwd=jcnn.mlp_fwd).train(
        init, jpq, jtg, batch=batch, epochs=1, seed=5)
    tout, tl = tparity.ParityTrainer(fwd=tcnn.mlp_fwd).train(
        tinit, tpq, ttg, batch=batch, epochs=1, seed=5)
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _close_trees(tout, jout, 1e-4)
    # the caller's init is left as it was
    _close_trees(tinit, init, 0)


def test_params_round_trip():
    tree = {"a": [np.arange(6, dtype=np.float32).reshape(2, 3)],
            "b": (np.ones(2, np.float32), {"c": np.zeros((1, 1))})}
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    doubled = tree_map(lambda t: t * 2, params_from_numpy(tree, "cpu"))
    assert float(doubled["a"][0][1, 2]) == 10.0
