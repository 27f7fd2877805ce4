"""LM training in the port (the block scan's custom VJP, remat, ``lm_loss``,
``training/train_lib.make_train_step``) against the JAX package, on the CPU.
The parity and joint train steps are in ``test_torch_parity_train.py``.

The same seeded numpy inputs and parameters go through ``repro`` and
``repro_torch``; parameters are carried across with ``params_from_numpy``.
Tolerances: 1e-5 for the custom VJP's output and gradients (fp32), 1e-5
relative for losses, and ``PARAM_TOL`` = 1e-6 for the parameters after three
Adam steps.  The train steps run Adam with ``eps`` = 1e-3 (``adam_update``
itself is held against the reference at the default eps in
``test_torch_models.py``): the two packages' fp32 gradients differ by
~1e-7, and at eps = 1e-8 an entry whose gradient is that small (there are a
few in every leaf) is moved by up to lr on rounding alone, since Adam
divides by |g| + eps.  With eps = 1e-3 a gradient difference dg moves an
entry by at most lr * dg / eps = 1e-7 per step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import loss as jloss
from repro.training import optim as joptim
from repro.training import train_lib as jtrain
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, tree_leaves
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import loss as tloss
from repro_torch.training import optim as toptim
from repro_torch.training import train_lib as ttrain

VJP_TOL = 1e-5
LR, EPS = 1e-3, 1e-3
PARAM_TOL = 1e-6
ARCHS = ["smollm-135m", "qwen2-0.5b"]        # qwen2: QKV bias
B, S = 2, 8


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else _np(got)
    np.testing.assert_allclose(got, _np(want), atol=atol, rtol=rtol)


def _cfgs(arch):
    return jbase.get_config(arch, reduced=True), \
        tbase.get_config(arch, reduced=True)


def _params(jcfg, seed):
    """One parameter draw of the reference: (jax tree, numpy tree)."""
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, jax.tree.map(np.asarray, jp)


def _port(tree):
    return params_from_numpy(tree, "cpu")


def _opts():
    return joptim.AdamConfig(lr=LR, eps=EPS), \
        toptim.AdamConfig(lr=LR, eps=EPS)


# --------------------------------------------------------------------------
# the block scan's custom VJP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 8, 0), (True, 0, 5), (True, 8, 5), (False, 0, 0)])
def test_flash_core_gradients_equal_jax_grad(causal, window, q_offset):
    """_FlashCore's output and dq/dk/dv against ``jax.grad`` through the
    reference's ``flash_attention_xla`` (its custom VJP): q [2,37,4,16],
    k/v [2,37,2,16], block 16, so the last KV block is ragged (5 keys)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 37, 4, 16), (2, 37, 2, 16), (2, 37, 2, 16)))
    cot = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block=16)

    def jloss_fn(q, k, v):
        out = JL.flash_attention_xla(q, k, v, **kw)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss_fn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = L.flash_attention_xla(tq, tk, tv, **kw)
    assert tout.grad_fn is not None and \
        type(tout.grad_fn).__name__.startswith("_FlashCore")
    tgrads = torch.autograd.grad((tout * torch.tensor(cot)).sum(),
                                 (tq, tk, tv))
    _close(tout, jout, VJP_TOL)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, VJP_TOL)


def test_flash_core_gradients_equal_naive_autograd_bf16():
    """In bf16 the VJP is held against autograd through B7's plain version
    (naive softmax attention) on the same inputs in fp32: 3e-2, the bf16
    attention tolerance of the kernel tests."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for shape in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    cot = torch.randn((1, 40, 4, 16), generator=gen)

    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(
        (L.flash_attention_xla(*ins, block=16).float() * cot).sum(), ins)
    ins32 = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (ref.flash_attention_ref(*ins32) * cot).sum(), ins32)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, atol=3e-2, rtol=3e-2)


# --------------------------------------------------------------------------
# the B7 gradient trap, remat, lm_loss
# --------------------------------------------------------------------------
def test_flash_attention_op_refuses_a_gradient():
    """B7 has no backward: asked for a gradient, the op raises (on the CPU
    too, so a training forward routed to it fails here), and without one it
    runs."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 1, 16), torch.randn(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_op(q, k, v)
    with torch.no_grad():
        assert ops.flash_attention_op(q, k, v).grad_fn is None
    ops.flash_attention_op(q.detach(), k, v)        # nothing requires grad
    # a whole forward on the "kernels" backend with trained leaves raises
    _, tcfg = _cfgs("qwen2-0.5b")
    assert tcfg.attn_backend == "kernels"
    params = T.init_params(tcfg, 0, device="cpu")
    tree_leaves(params)[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        T.forward(tcfg, params, tokens=torch.zeros((1, 4), dtype=torch.long))


def _op_cases():
    """Each op of ``kernels/ops.py`` at a tiny shape: (name, call(x), x),
    ``x`` the input that is to require grad."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)
    q, kv = rnd(1, 8, 2, 16), rnd(1, 8, 1, 16)
    return {
        "parity_encode_op": (lambda x: ops.parity_encode_op(
            x, [1.0, 2.0]), rnd(2, 3, 5)),
        "parity_decode_op": (lambda x: ops.parity_decode_op(
            x, rnd(2, 3, 5), 0), rnd(3, 5)),
        "fused_encode_forward_op": (lambda x: ops.fused_encode_forward_op(
            rnd(2, 3, 5), [[1.0, 1.0]], x), rnd(1, 5, 4)),
        "multigroup_decode_op": (lambda x: ops.multigroup_decode_op(
            x, rnd(2, 2, 3, 5), [0, 1], [1.0, 1.0]), rnd(2, 3, 5)),
        "berrut_encode_op": (lambda x: ops.berrut_encode_op(
            x, [[0.5, 0.5]]), rnd(2, 3, 5)),
        "learned_project_op": (lambda x: ops.learned_project_op(
            rnd(4, 3, 5), x), rnd(4, 1)),
        "flash_attention_op": (lambda x: ops.flash_attention_op(
            x, kv, kv), q),
        "decode_attention_op": (lambda x: ops.decode_attention_op(
            x, kv, kv, 3), rnd(1, 2, 16)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_every_op_refuses_a_gradient(name):
    """No kernel has a backward, so every op of ``kernels/ops.py`` raises
    when asked for a gradient (on the CPU too, where its plain version
    would differentiate), and runs without a graph otherwise."""
    assert {n for n in dir(ops) if n.endswith("_op")} == set(_op_cases())
    call, x = _op_cases()[name]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call(x.requires_grad_(True))
    with torch.no_grad():
        assert call(x).grad_fn is None
    with torch.inference_mode():
        assert torch.isfinite(call(x)).all()
    assert call(x.detach()).grad_fn is None        # nothing requires grad


def test_train_steps_differentiate_on_the_torch_backend(monkeypatch):
    """Every train step builds its differentiated forward on
    attn_backend="torch": with cfg on "kernels" (the default) a step runs
    the custom VJP and never the flash op."""
    calls = {"vjp": 0}
    real = L._FlashCore.apply

    def counted(*a):
        calls["vjp"] += 1
        return real(*a)

    monkeypatch.setattr(L._FlashCore, "apply", counted)
    monkeypatch.setattr(ops, "flash_attention_op", None)   # any call fails
    _, tcfg = _cfgs("smollm-135m")
    params = T.init_params(tcfg, 0, device="cpu")
    opt = toptim.AdamConfig(lr=LR)
    step = ttrain.make_train_step(tcfg, opt)
    toks = torch.zeros((B, S), dtype=torch.long)
    step(params, toptim.adam_init(params, opt), {"tokens": toks})
    # remat (the default) runs each layer's forward again in the backward
    assert calls["vjp"] == 2 * tcfg.n_layers
    assert ttrain.grad_cfg(tcfg).attn_backend == "torch"
    assert tcfg.attn_backend == "kernels"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_no_remat(arch):
    """Checkpointing each group recomputes the same activations: the
    gradients with and without remat are equal."""
    _, tcfg = _cfgs(arch)
    tcfg = tcfg.replace(attn_backend="torch")
    params = T.init_params(tcfg, 0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab, (B, S)))

    def loss_fn(p, remat):
        logits, aux = T.forward(tcfg, p, tokens=toks, remat=remat)
        return tloss.lm_loss(logits, toks, aux)

    g0 = ttrain.value_and_grad(lambda p: loss_fn(p, False), params)
    g1 = ttrain.value_and_grad(lambda p: loss_fn(p, True), params)
    assert float(g0[0]) == float(g1[0])
    for a, b in zip(g0[1], g1[1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not any(p.grad is not None for p in tree_leaves(params))


def test_init_params_do_not_require_grad_and_meta_allocates_nothing():
    _, tcfg = _cfgs("qwen2-0.5b")
    assert not any(p.requires_grad
                   for p in tree_leaves(T.init_params(tcfg, 0,
                                                      device="cpu")))
    meta = T.init_params(tcfg, 0, device="meta")
    assert all(p.device.type == "meta" for p in tree_leaves(meta))


def test_lm_loss_equals_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jloss.lm_loss(jnp.asarray(logits), jnp.asarray(toks), 0.5, 0.02)
    got = tloss.lm_loss(torch.tensor(logits), torch.tensor(toks), 0.5, 0.02)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss.lm_loss(torch.tensor(logits), torch.tensor(toks))),
        float(jloss.lm_loss(jnp.asarray(logits), jnp.asarray(toks))),
        rtol=1e-6)


# --------------------------------------------------------------------------
# train_lib.make_train_step: three steps against the reference
# --------------------------------------------------------------------------
def _token_batches(vocab, n=3):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (B, S)).astype(np.int32)
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_train(arch):
    """The reference's make_train_step over three batches from seed-0
    parameters: (losses, final leaves).  Computed once per arch for both
    remat cases: remat changes what is kept, not the values."""
    jcfg, _ = _cfgs(arch)
    jp, _ = _params(jcfg, 0)
    jopt, _ = _opts()
    step = jax.jit(jtrain.make_train_step(jcfg, jopt, remat=True))
    state, losses = joptim.adam_init(jp, jopt), []
    for toks in _token_batches(jcfg.vocab):
        jp, state, m = step(jp, state, {"tokens": jnp.asarray(toks)})
        losses.append(float(m["loss"]))
    assert int(state["step"]) == len(losses)
    return losses, [np.asarray(x) for x in jax.tree.leaves(jp)]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_equals_reference(arch, remat):
    jcfg, tcfg = _cfgs(arch)
    tp = _port(_params(jcfg, 0)[1])
    _, topt = _opts()
    step = ttrain.make_train_step(tcfg, topt, remat=remat)
    state = toptim.adam_init(tp, topt)
    want_losses, want_leaves = _reference_train(arch)
    for toks, want in zip(_token_batches(jcfg.vocab), want_losses):
        trained, state, m = step(tp, state, {"tokens": torch.tensor(toks)})
        assert trained is tp              # updated in place, as documented
        np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-5)
    assert state["step"] == len(want_losses)
    leaves = tree_leaves(tp)
    assert len(leaves) == len(want_leaves)
    for got, want in zip(leaves, want_leaves):
        _close(got, want, PARAM_TOL)


def test_init_train_state_on_cpu():
    _, tcfg = _cfgs("smollm-135m")
    opt = toptim.AdamConfig()
    params, state = ttrain.init_train_state(tcfg, 0, opt, device="cpu")
    assert state["step"] == 0
    assert [tuple(m.shape) for m in tree_leaves(state["mu"])] == \
        [tuple(p.shape) for p in tree_leaves(params)]
    assert dataclasses.asdict(opt) == dataclasses.asdict(
        joptim.AdamConfig())
