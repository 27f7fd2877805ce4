"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``models/moe.py`` (``_moe_fwd_global``), on the CPU.

The same seeded numpy inputs and parameters go through both packages;
parameters are carried across with ``params_from_numpy``.  Tolerances: fp32
1e-5 for outputs, aux and gradients; 2e-2 for the bf16 case (the expert
products round to bf16 on both sides, in other orders).  The inputs are
random fp32, where router probabilities do not tie, so ``torch.topk`` and
``lax.top_k`` pick the same experts in the same order.  Then the
reference's own properties (``tests/test_moe_mamba.py``), each on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as jbase
from repro.models import moe as JMOE
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, tree_leaves
from repro_torch.models import moe as MOE

TOL = 1e-5
BF16 = 2e-2


def _cfgs(**kw):
    j = jbase.get_config("deepseek-moe-16b", reduced=True)
    t = tbase.get_config("deepseek-moe-16b", reduced=True)
    return j.replace(**kw), t.replace(**kw)


def _params(jcfg, seed=0):
    """The reference's draw, with the zero / unit leaves perturbed:
    (jax tree, torch tree)."""
    p = JMOE.init_moe(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.asarray(
        np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape),
        np.float32).astype(a.dtype), p)
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


def _x(shape, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _jax_dropped(jcfg, router, xt, C):
    """The reference's (token, k) placement (``_moe_fwd_global``): expert
    and place of each assignment in the flattened [T*K] order."""
    probs = jax.nn.softmax(xt @ router, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, jcfg.moe_top_k)
    flat_e = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              flat_e[:, None], axis=1)[:, 0]
    return np.asarray(flat_e), np.asarray(pos), np.asarray(pos >= C)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------
def test_init_moe_layout_and_distributions():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = JMOE.init_moe(jcfg, jax.random.PRNGKey(0))
    tp = MOE.init_moe(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert [str(t.dtype).removeprefix("torch.") for t in tree_leaves(tp)] \
        == [str(j.dtype) for j in jax.tree.leaves(jp)]
    assert tp["router"].dtype == torch.float32          # even in bf16
    # the router is a bf16 draw kept in fp32
    assert torch.equal(tp["router"], tp["router"].bfloat16().float())
    D, Fd = tcfg.d_model, tcfg.moe_d_ff
    for name, fan in (("w1", D), ("w3", D), ("w2", Fd), ("router", D)):
        std = float(tp[name].float().std()) * fan ** 0.5
        assert abs(std - 1.0) < 0.05, name
    # drawn one stacked slice at a time: lead=(G,) gives G distinct draws
    lead = MOE.init_moe(tcfg, torch.Generator().manual_seed(0), lead=(3,))
    assert lead["w1"].shape == (3,) + tuple(tp["w1"].shape)
    assert not torch.equal(lead["w1"][0], lead["w1"][1])


@pytest.mark.parametrize("n", [1, 7, 64, 910, 4000])
def test_expert_capacity_equals_reference(n):
    for arch in ("deepseek-moe-16b", "qwen3-moe-235b-a22b",
                 "jamba-1.5-large-398b"):
        for reduced in (False, True):
            assert MOE.expert_capacity(n, tbase.get_config(arch, reduced)) \
                == JMOE.expert_capacity(n, jbase.get_config(arch, reduced))


@pytest.mark.parametrize("capacity", [None, 8])
@pytest.mark.parametrize("shared", [1, 0])
def test_moe_fwd_matches_reference(shared, capacity):
    """Output and aux of ``moe_fwd`` equal ``_moe_fwd_global``'s; with the
    forced capacity of 8 (64 tokens, top-2 over 4 experts) assignments drop,
    and the port drops the reference's set."""
    jcfg, tcfg = _cfgs(n_shared_experts=shared)
    jp, tp = _params(jcfg)
    x = _x((2, 32, jcfg.d_model))
    want, want_aux = JMOE._moe_fwd_global(jcfg, jp, jnp.asarray(x),
                                          capacity=capacity)
    got, aux = MOE.moe_fwd(tcfg, tp, torch.tensor(x), capacity=capacity)
    _close(got, want, TOL)
    _close(aux, want_aux, TOL)
    xt = x.reshape(-1, jcfg.d_model)
    C = capacity or JMOE.expert_capacity(xt.shape[0], jcfg)
    flat_e, pos, dropped = _jax_dropped(jcfg, jp["router"], xt, C)
    _, t_e, t_pos, keep, _ = MOE.route(tcfg, tp["router"], torch.tensor(xt),
                                       C)
    np.testing.assert_array_equal(t_e.numpy(), flat_e)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(~keep.numpy(), dropped)
    assert dropped.any() == (capacity is not None)


def test_moe_fwd_bf16_matches_reference():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp, tp = _params(jcfg)
    x = _x((2, 16, jcfg.d_model))
    want, want_aux = JMOE._moe_fwd_global(jcfg, jp,
                                          jnp.asarray(x, jnp.bfloat16))
    got, aux = MOE.moe_fwd(tcfg, tp, torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)
    _close(aux, want_aux, TOL)


def test_moe_gradients_match_reference():
    """d(sum(out^2) + aux) by every leaf and by x, autograd against
    ``jax.grad``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, 8, jcfg.d_model))

    def jloss(p, x):
        out, aux = JMOE._moe_fwd_global(jcfg, p, x)
        return jnp.sum(out ** 2) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = MOE.moe_fwd(tcfg, tp, tx)
    # the norm scale is applied by the layer around moe_fwd: zero gradient
    grads = torch.autograd.grad((out ** 2).sum() + aux, leaves + [tx],
                                materialize_grads=True)
    for g, w in zip(grads, jax.tree.leaves(jg) + [jgx]):
        _close(g, w, TOL)


# --------------------------------------------------------------------------
# the reference's properties, on the port
# --------------------------------------------------------------------------
def test_moe_matches_dense_reference():
    """With no capacity drops, scatter-dispatch MoE == explicit per-token
    top-k loop."""
    _, cfg = _cfgs(capacity_factor=8.0)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0))
    x = 0.1 * torch.randn((2, 8, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    got, aux = MOE.moe_fwd(cfg, p, x)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], -1)
    gv, gi = torch.topk(probs, cfg.moe_top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.moe_top_k):
            e = int(gi[t, j])
            h = F.silu(xt[t] @ p["w1"][e]) * (xt[t] @ p["w3"][e])
            want[t] += gv[t, j] * (h @ p["w2"][e])
    sp = p["shared"]
    want = want + (F.silu(xt @ sp["w1"]) * (xt @ sp["w3"])) @ sp["w2"]
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want,
                               atol=1e-4, rtol=0)
    assert float(aux) > 0


def test_moe_capacity_drops_tokens():
    """With capacity 8 per expert and 256 tokens, overflow assignments add
    nothing: no NaNs, and a token whose every assignment dropped gets a zero
    output (no shared experts)."""
    _, cfg = _cfgs(n_shared_experts=0)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0))
    x = 0.1 * torch.randn((4, 64, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    out, aux = MOE.moe_fwd(cfg, p, x, capacity=8)
    assert torch.isfinite(out).all() and torch.isfinite(aux)
    _, _, _, keep, _ = MOE.route(cfg, p["router"],
                                 x.reshape(-1, cfg.d_model), 8)
    assert int(keep.sum()) <= 8 * cfg.n_experts
    none_kept = ~keep.reshape(-1, cfg.moe_top_k).any(1)
    assert none_kept.any()
    assert torch.equal(out.reshape(-1, cfg.d_model)[none_kept],
                       torch.zeros_like(out.reshape(-1, cfg.d_model)[
                           none_kept]))


def test_moe_aux_loss_uniform_routing():
    """Perfectly uniform routing gives aux ~= 1 (E * sum(1/E * 1/E) * E)."""
    _, cfg = _cfgs()
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0))
    p = dict(p, router=torch.zeros_like(p["router"]))        # uniform probs
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    _, aux = MOE.moe_fwd(cfg, p, x)
    assert 0.9 < float(aux) < 1.3
