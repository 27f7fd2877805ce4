"""The port's Mamba2 / SSD mixer (``repro_torch.models.mamba``) against the
JAX package's ``models/mamba.py``, on the CPU.

The same seeded numpy inputs and parameters go through both packages;
parameters are carried across with ``params_from_numpy``.  Tolerances: fp32
1e-5 for outputs and states (``TOL``), and for gradients 1e-5 of each
leaf's largest plus 1e-4 of each entry; 2e-4 for the reference's
own properties, as ``tests/test_moe_mamba.py`` states them.  Gradients are
compared at the reduced ``ssm_chunk`` only: at the full chunk of 256 both
packages give the same non-finite gradients (the masked intra-chunk decay,
``ROADMAP.md`` §C), which a test here pins.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import mamba as JM
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, tree_leaves
from repro_torch.models import mamba as M

TOL = 1e-5
PROP = 2e-4


def _cfgs(**kw):
    j = jbase.get_config("mamba2-780m", reduced=True)
    t = tbase.get_config("mamba2-780m", reduced=True)
    return j.replace(**kw), t.replace(**kw)


def _params(jcfg, seed=0):
    """The reference's draw with the zero / unit leaves perturbed:
    (jax tree, torch tree)."""
    p = JM.init_mamba(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.05 *
                                rng.standard_normal(a.shape)).astype(
        np.float32), p)
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


def _x(shape, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _state(cfg, B, seed):
    """A random SSM cache of the reference's shapes (numpy)."""
    di, H, P, N, G, conv_dim = M._dims(cfg)
    return {"ssm": _x((B, H, N, P), seed, 0.3),
            "conv": _x((B, cfg.ssm_conv - 1, conv_dim), seed + 1, 0.3)}


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------
def test_init_mamba_layout_and_distributions():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = JM.init_mamba(jcfg, jax.random.PRNGKey(0))
    tp = M.init_mamba(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert [str(t.dtype).removeprefix("torch.") for t in tree_leaves(tp)] \
        == [str(j.dtype) for j in jax.tree.leaves(jp)]
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32, name     # even in bf16
    # dt = softplus(dt_bias) in [1e-3, 1e-1]; A = exp(A_log) in [1, 16]
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    A = torch.exp(tp["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0
    assert abs(float(tp["in_proj"].float().std()) * math.sqrt(
        tcfg.d_model) - 1.0) < 0.05
    lead = M.init_mamba(tcfg, torch.Generator().manual_seed(0), lead=(2,))
    assert lead["in_proj"].shape == (2,) + tuple(tp["in_proj"].shape)


def test_causal_conv_and_tail_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, 9, jcfg.d_model))
    _, conv_dim = M._dims(tcfg)[0], M._dims(tcfg)[5]
    xbc = _x((2, 9, conv_dim), 3)
    _close(M._causal_conv(torch.tensor(xbc), tp["conv_w"], tp["conv_b"]),
           JM._causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"]), TOL)
    _close(M.xBC_tail(tcfg, torch.tensor(x), tp),
           JM.xBC_tail(jcfg, jnp.asarray(x), jp), TOL)
    for a, b in zip(M._split_in(tcfg, tp, torch.tensor(x)),
                    JM._split_in(jcfg, jp, jnp.asarray(x))):
        _close(a, b, TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk,L", [(32, 40), (32, 64), (8, 21), (16, 3)])
def test_ssd_fwd_matches_reference(chunk, L, init):
    """Output, final state and conv tail of ``ssd_fwd`` (``return_state``),
    from a zero or a given ``init_state``, over padded and unpadded
    chunkings; and the output alone without ``return_state``."""
    jcfg, tcfg = _cfgs(ssm_chunk=chunk)
    jp, tp = _params(jcfg)
    x = _x((2, L, jcfg.d_model))
    h0 = _state(jcfg, 2, 5)["ssm"] if init else None
    want, wst = JM.ssd_fwd(jcfg, jp, jnp.asarray(x), return_state=True,
                           init_state=None if h0 is None else jnp.asarray(h0))
    got, st = M.ssd_fwd(tcfg, tp, torch.tensor(x), return_state=True,
                        init_state=None if h0 is None else torch.tensor(h0))
    _close(got, want, TOL)
    _close(st["ssm"], wst["ssm"], TOL)
    _close(st["conv"], wst["conv"], TOL)
    assert st["ssm"].dtype == torch.float32
    alone, none = M.ssd_fwd(tcfg, tp, torch.tensor(x),
                            init_state=None if h0 is None else
                            torch.tensor(h0))
    assert none is None
    _close(alone, want, TOL)


def test_ssd_decode_matches_reference():
    """Four recurrence steps from a random cache: outputs and the new state
    and conv tail of each."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    cache = _state(jcfg, 3, 7)
    jc = jax.tree.map(jnp.asarray, cache)
    tc = {k: torch.tensor(v) for k, v in cache.items()}
    for t in range(4):
        x = _x((3, 1, jcfg.d_model), 20 + t)
        want, jc = JM.ssd_decode(jcfg, jp, jnp.asarray(x), jc)
        got, tc = M.ssd_decode(tcfg, tp, torch.tensor(x), tc)
        _close(got, want, TOL)
        _close(tc["ssm"], jc["ssm"], TOL)
        _close(tc["conv"], jc["conv"], TOL)


def test_init_ssm_cache_equals_reference():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    want = JM.init_ssm_cache(jcfg, 3)
    got = M.init_ssm_cache(tcfg, 3, lead=(2,))
    for name in ("ssm", "conv"):
        assert tuple(got[name].shape) == (2,) + want[name].shape
        assert str(got[name].dtype).removeprefix("torch.") == \
            str(want[name].dtype)
        assert not got[name].any()


def test_ssd_gradients_match_reference():
    """d(sum(y^2)) by every leaf and by x at the reduced chunk (32) over two
    chunks and a padded third, autograd against ``jax.grad``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((1, 70, jcfg.d_model))

    def jloss(p, x):
        return jnp.sum(JM.ssd_fwd(jcfg, p, x)[0] ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    y, _ = M.ssd_fwd(tcfg, tp, tx)
    # the norm scale is applied by the layer around ssd_fwd: zero gradient
    grads = torch.autograd.grad((y ** 2).sum(), leaves + [tx],
                                materialize_grads=True)
    for g, w in zip(grads, jax.tree.leaves(jg) + [jgx]):
        # relative to the leaf's largest gradient, and 1e-4 relative to
        # each entry: the per-head leaves (A_log, dt_bias, D) sum cancelling
        # terms over every position, in another order in each package
        w = np.asarray(w)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=TOL * max(1.0, np.abs(w).max()))


def test_full_chunk_gradient_trap_as_in_reference():
    """At ``ssm_chunk`` 256 over 256 tokens the forward is finite and equal
    to the reference's, and the same leaves' gradients are non-finite in
    both packages: exp(cum_i - cum_j) overflows for i < j before the mask
    (``ROADMAP.md`` §C)."""
    jcfg, tcfg = _cfgs(ssm_chunk=256)
    jp, tp = _params(jcfg)
    x = _x((1, 256, jcfg.d_model))

    def jloss(p):
        return jnp.sum(JM.ssd_fwd(jcfg, p, jnp.asarray(x))[0])

    jval, jg = jax.value_and_grad(jloss)(jp)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, _ = M.ssd_fwd(tcfg, tp, torch.tensor(x))
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(float(y.detach().sum()), float(jval),
                               rtol=1e-4)
    grads = torch.autograd.grad(y.sum(), leaves, materialize_grads=True)
    got = [not bool(torch.isfinite(g).all()) for g in grads]
    want = [not bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jg)]
    assert got == want and any(want)


# --------------------------------------------------------------------------
# the reference's properties, on the port
# --------------------------------------------------------------------------
def _prop_setup(seed=0, chunk=4):
    _, cfg = _cfgs(ssm_chunk=chunk)
    return cfg, M.init_mamba(cfg, torch.Generator().manual_seed(seed))


def test_ssd_matches_stepwise_recurrence():
    """Chunked SSD (prefill path) == token-by-token decode recurrence."""
    cfg, p = _prop_setup()
    B, L = 2, 12
    x = 0.1 * torch.randn((B, L, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    y_full, _ = M.ssd_fwd(cfg, p, x)
    cache = M.init_ssm_cache(cfg, B)
    ys = []
    for t in range(L):
        y, cache = M.ssd_decode(cfg, p, x[:, t:t + 1], cache)
        ys.append(y)
    torch.testing.assert_close(y_full, torch.cat(ys, 1), atol=PROP, rtol=0)


def test_ssd_prefill_state_handoff():
    """ssd_fwd(return_state) then ssd_decode continues exactly."""
    cfg, p = _prop_setup()
    B, L = 1, 8
    x = 0.1 * torch.randn((B, L + 1, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    y_full, _ = M.ssd_fwd(cfg, p, x)
    _, state = M.ssd_fwd(cfg, p, x[:, :L], return_state=True)
    y_next, _ = M.ssd_decode(cfg, p, x[:, L:L + 1], state)
    torch.testing.assert_close(y_next, y_full[:, L:], atol=PROP, rtol=0)


@pytest.mark.parametrize("L,seed", [
    (1, 0), (3, 7), (4, 13), (7, 21), (11, 29), (15, 37), (16, 50),
])
def test_ssd_chunk_padding_invariance(L, seed):
    """Output is independent of chunk-size / padding choices."""
    cfg, p = _prop_setup(seed, chunk=32)
    x = 0.1 * torch.randn((1, L, cfg.d_model),
                          generator=torch.Generator().manual_seed(seed + 1))
    y1, _ = M.ssd_fwd(cfg.replace(ssm_chunk=4), p, x)
    y2, _ = M.ssd_fwd(cfg.replace(ssm_chunk=16), p, x)
    torch.testing.assert_close(y1, y2, atol=PROP, rtol=0)
