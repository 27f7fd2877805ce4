"""The port's parity distillation step (``training/train_lib.py``:
``make_parity_train_step``) against the JAX package, on the CPU, three steps
on reduced smollm-135m and reduced qwen2-0.5b (QKV bias).  The joint
encoder + parity step is in ``test_torch_joint_train.py``.

The same seeded numpy parameters, member embeddings and teacher logits go
through both packages; parameters are carried across with
``params_from_numpy``.  Tolerances: losses 1e-5 relative, parameters 1e-6
after three steps, with Adam's eps at 1e-3 (``tests/test_torch_train.py``
says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.training import optim as joptim
from repro.training import train_lib as jtrain
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, tree_leaves
from repro_torch.training import optim as toptim
from repro_torch.training import train_lib as ttrain

LR, EPS = 1e-3, 1e-3
PARAM_TOL = 1e-6
ARCHS = ["smollm-135m", "qwen2-0.5b"]
K, B, S = 2, 2, 8


def _cfgs(arch):
    return jbase.get_config(arch, reduced=True), \
        tbase.get_config(arch, reduced=True)


def _params(jcfg, seed):
    """One parameter draw of the reference: (jax tree, port tree)."""
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _opts():
    return joptim.AdamConfig(lr=LR, eps=EPS), \
        toptim.AdamConfig(lr=LR, eps=EPS)


def _batches(cfg, n=3):
    """n batches of member embeddings [K,B,S,D] and teacher logits
    [K,B,S,V]: (jax batch, torch batch) pairs."""
    rng = np.random.default_rng(2)
    out = []
    for _ in range(n):
        emb = (0.02 * rng.standard_normal((K, B, S, cfg.d_model))).astype(
            np.float32)
        teach = rng.standard_normal((K, B, S, cfg.vocab)).astype(np.float32)
        out.append(({"embeds": jnp.asarray(emb),
                     "teacher": jnp.asarray(teach)},
                    {"embeds": torch.tensor(emb),
                     "teacher": torch.tensor(teach)}))
    return out


def _run_both(jstep, tstep, jparams, tparams, batches):
    """Three steps through each package; the losses agree step by step and
    the updated parameters at the end."""
    jopt, topt = _opts()
    jstep = jax.jit(jstep(jopt))
    tstep = tstep(topt)
    jstate = joptim.adam_init(jparams, jopt)
    tstate = toptim.adam_init(tparams, topt)
    for jb, tb in batches:
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        trained, tstate, tm = tstep(tparams, tstate, tb)
        assert trained is tparams         # updated in place
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == len(batches)
    tl, jl = tree_leaves(tparams), jax.tree.leaves(jparams)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=PARAM_TOL)


@pytest.mark.parametrize("coeffs", [None, [1, 2]])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_parity_train_step_equals_reference(arch, coeffs):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, 1)
    _run_both(
        lambda o: jtrain.make_parity_train_step(jcfg, o, coeffs=coeffs),
        lambda o: ttrain.make_parity_train_step(tcfg, o, coeffs=coeffs),
        jp, tp, _batches(jcfg))
