"""The second slice's schemes — ``approxifer``, ``learned``, ``fisher`` and
``invnet`` — against the JAX package's, on the same seeded numpy inputs and,
where a scheme has parameters, on the JAX package's parameters carried across
with ``params_from_numpy``.  Both backends of the port run (``torch``, and
``kernels``, whose CPU path is the kernels' plain versions); the JAX side runs
``jnp``, and ``pallas`` in interpret mode where a kernel is involved.

Also here: the checkpoint ``.npz`` interop between the packages, and the
singular-decode rule (a system that cannot be solved gives non-finite values,
as JAX's solve does, instead of raising).

Tolerances: 1e-5 for encodes and decodes (fp32, reductions over k <= 4),
1e-4 relative for joint training and Fisher diagonals (accumulated over
steps or a calibration batch); float64 host matrices and invnet's integer
substrate are held exactly."""
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import approxifer as japx
from repro.core import fisher as jfisher
from repro.core import invnet as jinv
from repro.core import learned as jlearned
from repro.core import parity as jparity
from repro.core import scheme as jscheme
from repro.models import cnn as jcnn
from repro_torch.checkpoint import io as tio
from repro_torch.convert import params_from_numpy, params_to_numpy, to_host
from repro_torch.core import approxifer as tapx
from repro_torch.core import fisher as tfisher
from repro_torch.core import invnet as tinv
from repro_torch.core import learned as tlearned
from repro_torch.core import parity as tparity
from repro_torch.core import scheme as tscheme
from repro_torch.models import cnn as tcnn

BACKENDS = ("torch", "kernels")
NEW = ("approxifer", "learned", "fisher", "invnet")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(to_host(got), np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _close_trees(got, want, rtol, atol=1e-6):
    g, w = jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _ideal(scheme, outs):
    """Parity outputs of a linear deployed model: the member outputs'
    interpolant at the parity nodes."""
    return np.einsum("rk,k...->r...", np.asarray(scheme.coeffs, np.float32),
                     outs)


# ------------------------------------------------------------- registry ---
@pytest.mark.parametrize("name", NEW)
def test_new_names_resolve_on_cpu_and_raise_without_a_card(name):
    """Every new name resolves on ``device="cpu"`` with the reference's k, r
    and capabilities; without ``device`` it asks for the card, and there is
    none here."""
    port = tscheme.get_scheme(name, k=2, device="cpu")
    ref = jscheme.get_scheme(name, k=2)
    assert (port.name, port.k, port.r, port.backend, port.device) == \
        (name, 2, 1, "kernels", "cpu")
    assert tscheme.scheme_capabilities(port) == \
        tscheme.Capabilities(**vars(jscheme.scheme_capabilities(ref)))
    assert tscheme.decode_cost(port, 2) == jscheme.decode_cost(ref, 2)
    assert tscheme.encode_cost(port) == jscheme.encode_cost(ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda is not"):
            tscheme.get_scheme(name, k=2)


# ----------------------------------------------------------- approxifer ---
APX_KR = [(2, 1), (2, 2), (3, 1), (3, 2), (4, 2), (4, 3), (5, 1), (6, 2)]


@pytest.mark.parametrize("k,r", APX_KR)
def test_approxifer_matrices_equal_reference(k, r):
    """Nodes, the encode coefficients, the decode design and the r=1 decode
    weights are the reference's float64 host numbers, exactly."""
    port = tscheme.get_scheme("approxifer", k=k, r=r, device="cpu")
    ref = jscheme.get_scheme("approxifer", k=k, r=r)
    np.testing.assert_array_equal(port.member_nodes, ref.member_nodes)
    np.testing.assert_array_equal(port.parity_nodes, ref.parity_nodes)
    np.testing.assert_array_equal(port.host_coeffs, np.asarray(ref.coeffs))
    np.testing.assert_array_equal(port.coeffs.numpy(), np.asarray(ref.coeffs))
    np.testing.assert_array_equal(port._design_np, ref._design_np)
    np.testing.assert_array_equal(port._decode_one_w, ref._decode_one_w)
    np.testing.assert_array_equal(
        tapx.lagrange_eval_matrix(tapx.chebyshev_nodes(k + r), [0.3, -0.9]),
        japx.lagrange_eval_matrix(japx.chebyshev_nodes(k + r), [0.3, -0.9]))
    # partition of unity: a constant group encodes to that constant
    np.testing.assert_allclose(port.host_coeffs.sum(1), np.ones(r),
                               atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,r,shape", [(2, 1, (3, 8)), (3, 2, (1, 4, 4, 1)),
                                       (4, 2, (2, 130)), (2, 2, (9, 5)),
                                       (3, 1, (7,))])
def test_approxifer_encode(k, r, shape, backend):
    q = np.random.default_rng(3 * k + r).normal(
        size=(k,) + shape).astype(np.float32)
    port = tscheme.get_scheme("approxifer", k=k, r=r, backend=backend,
                              device="cpu")
    got = port.encode(q)
    assert tuple(got.shape) == (r,) + shape
    _close(got, jscheme.get_scheme("approxifer", k=k, r=r).encode(
        jnp.asarray(q)))
    _close(port(torch.tensor(q)), jscheme.get_scheme(
        "approxifer", k=k, r=r, backend="pallas").encode(jnp.asarray(q)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,r", [(2, 2), (3, 2), (4, 2), (4, 3)])
def test_approxifer_decode_every_arrival_pattern(k, r, backend):
    """For every split of e <= r losses across members and parities, the
    port's masked least-squares refit agrees with the reference's, and both
    rebuild the missing members of a linear model.  Tolerance 1e-3: the fp32
    normal equations square the Chebyshev design's condition number, and
    the two packages' LU solves round differently (2.1e-5 apart at worst
    here, 2.7e-4 at k=4, r=3, where G's condition number is largest); both
    stay within the reference's 5e-3 of the true outputs."""
    port = tscheme.get_scheme("approxifer", k=k, r=r, backend=backend,
                              device="cpu")
    ref = jscheme.get_scheme("approxifer", k=k, r=r)
    outs = np.random.default_rng(7 * k + r).normal(
        size=(k, 6)).astype(np.float32)
    parity = _ideal(ref, outs)
    for e in range(1, r + 1):
        for lost in combinations(range(k + r), e):
            miss = np.zeros(k, bool)
            pa = np.ones(r, bool)
            for t in lost:
                if t < k:
                    miss[t] = True
                else:
                    pa[t - k] = False
            assert tscheme.recoverable_rows(port, miss, pa).tolist() == \
                jscheme.recoverable_rows(ref, miss, pa).tolist()
            held = np.where(miss[:, None], 999.0, outs).astype(np.float32)
            po = parity * pa[:, None]
            want = np.asarray(ref.decode(jnp.asarray(po), jnp.asarray(held),
                                         jnp.asarray(miss), jnp.asarray(pa)))
            got = port.decode(po, held, miss, pa)
            _close(got, want, 1e-3)
            np.testing.assert_allclose(to_host(got), outs, atol=5e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_approxifer_all_extra_responses_lost(backend):
    port = tscheme.get_scheme("approxifer", k=2, r=2, backend=backend,
                              device="cpu")
    outs = np.random.default_rng(0).normal(size=(2, 4)).astype(np.float32)
    none = np.zeros(2, bool)
    _close(port.decode(np.zeros((2, 4), np.float32), outs, none, none), outs,
           1e-6)
    assert not tscheme.recoverable_rows(port, np.array([True, False]),
                                        none).any()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("batched", [False, True])
def test_approxifer_decode_one(k, backend, batched):
    """The r=1 hot path (B3's plain version under ``kernels``) against the
    reference's ``jnp`` and interpret-mode ``pallas`` decode_one."""
    shape = (k, 2, 6) if batched else (k, 6)
    outs = np.random.default_rng(k).normal(size=shape).astype(np.float32)
    port = tscheme.get_scheme("approxifer", k=k, backend=backend,
                              device="cpu")
    ref = jscheme.get_scheme("approxifer", k=k)
    pls = jscheme.get_scheme("approxifer", k=k, backend="pallas")
    parity = _ideal(ref, outs)
    for j in range(k):
        got = port.decode_one(parity[0], outs, j)
        _close(got, ref.decode_one(jnp.asarray(parity[0]),
                                   jnp.asarray(outs), j))
        _close(got, pls.decode_one(jnp.asarray(parity[0]),
                                   jnp.asarray(outs), j))
        np.testing.assert_allclose(to_host(got), outs[j], atol=5e-3)


def _vote_case(case):
    """The reference's four voting cases: (k, r, member_outs, parity_outs,
    parity_avail)."""
    k, r, seed = {"member": (2, 2, 1), "parity": (2, 2, 2),
                  "abstain": (2, 2, 3), "clean": (3, 2, 4)}[case]
    scheme = jscheme.get_scheme("approxifer", k=k, r=r)
    outs = np.random.default_rng(seed).normal(
        size=(k, 5 if case == "clean" else 4)).astype(np.float32)
    parity = _ideal(scheme, outs).copy()
    pa = np.ones(r, bool)
    if case == "member":
        outs[1] += 1e3
    elif case == "parity":
        parity[0] -= 1e3
    elif case == "abstain":
        outs[0] += 1e3
        pa = np.array([True, False])
    return k, r, outs, parity, pa


@pytest.mark.parametrize("case,want_m,want_p", [
    ("member", [False, True], [False, False]),
    ("parity", [False, False], [True, False]),
    ("abstain", [False, False], [False, False]),
    ("clean", [False, False, False], [False, False])])
def test_approxifer_flag_errors(case, want_m, want_p):
    k, r, outs, parity, pa = _vote_case(case)
    port = tscheme.get_scheme("approxifer", k=k, r=r, device="cpu")
    ref = jscheme.get_scheme("approxifer", k=k, r=r)
    for member_outs in (outs, torch.tensor(outs)):
        mf, pf = port.flag_errors(member_outs, np.ones(k, bool), parity, pa)
        rmf, rpf = ref.flag_errors(outs, np.ones(k, bool), parity, pa)
        assert mf.tolist() == rmf.tolist() == want_m
        assert pf.tolist() == rpf.tolist() == want_p


def test_approxifer_bounds_validation_and_training_free_provisioning():
    port = tscheme.get_scheme("approxifer", k=4, r=3, device="cpu")
    ref = jscheme.get_scheme("approxifer", k=4, r=3)
    for n in range(3, 9):
        assert port.max_correctable(n) == ref.max_correctable(n)
    with pytest.raises(ValueError, match="k >= 2"):
        tapx.ApproxIFERScheme(k=1, device="cpu")
    with pytest.raises(ValueError, match="r must be"):
        tapx.ApproxIFERScheme(k=2, r=0, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tapx.ApproxIFERScheme(k=2, backend="pallas", device="cpu")
    W = torch.ones(6, 3)
    pp, scheme = tparity.train_parity_models(
        W, lambda p, xb: torch.as_tensor(xb) @ p, init_fn=None,
        x_train=np.zeros((32, 6), np.float32), k=2, r=2,
        scheme="approxifer", device="cpu")
    assert scheme.name == "approxifer" and len(pp) == 2
    assert all(p is W for p in pp)


# -------------------------------------------------------------- learned ---
def _enc_np(k, r, hidden=16, seed=0, alpha=0.0):
    return _np(jlearned.init_encoder_params(k, r, hidden, seed, alpha=alpha))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,r", [(2, 1), (3, 2)])
def test_learned_fresh_scheme_encodes_exactly_as_sum(k, r, backend):
    """alpha = 0: whatever the torch.Generator drew for w1 and w2, a fresh
    scheme's encode is bit-for-bit the sum code's on the same backend."""
    q = np.random.default_rng(k).normal(size=(k, 3, 10)).astype(np.float32)
    for seed in (0, 5):
        learned = tscheme.get_scheme("learned", k=k, r=r, backend=backend,
                                     enc_seed=seed, device="cpu")
        assert float(learned.enc_params["alpha"]) == 0.0
        want = tscheme.get_scheme("sum", k=k, r=r, backend=backend,
                                  device="cpu").encode(q)
        assert torch.equal(learned.encode(q), want)
    a = tlearned.init_encoder_params(k, r, 16, seed=3, device="cpu")
    b = tlearned.init_encoder_params(k, r, 16, seed=3, device="cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,r,shape", [(2, 1, (3, 10)), (3, 2, (2, 4, 4, 1)),
                                       (2, 2, (5,))])
def test_learned_encode_with_carried_params(k, r, shape, backend):
    """The reference's encoder params, alpha set non-zero, carried across:
    encode agrees with the reference's jnp and interpret-mode pallas
    paths."""
    enc = _enc_np(k, r, seed=2, alpha=0.7)
    q = np.random.default_rng(11).normal(size=(k,) + shape).astype(
        np.float32)
    port = tscheme.get_scheme("learned", k=k, r=r, backend=backend,
                              device="cpu").with_params(
        params_from_numpy(enc, "cpu"))
    assert port.enc_params["alpha"].ndim == 0
    got = port.encode(q)
    assert tuple(got.shape) == (r,) + shape
    for jb in ("jnp", "pallas"):
        ref = jscheme.get_scheme("learned", k=k, r=r, backend=jb,
                                 enc_params=jax.tree.map(jnp.asarray, enc))
        _close(got, ref.encode(jnp.asarray(q)))
    # the differentiable training path computes the same function
    _close(port.encode_with_params(port.enc_params, q),
           ref.encode(jnp.asarray(q)))


def _linear_j(p, x):
    return x.reshape(x.shape[0], -1) @ p["w"]


def _linear_t(p, x):
    x = torch.as_tensor(x)
    return x.reshape(x.shape[0], -1) @ p["w"]


@pytest.mark.parametrize("r", [1, 2])
def test_train_joint_three_steps_match_reference(r):
    """Three joint encoder+parity steps from the same carried initial
    params on the same numpy data: same grouping and batch order, losses
    and final params within 1e-4 relative."""
    k, F, V, seed = 2, 12, 4, 3
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, F)).astype(np.float32)        # 24 groups
    fx = rng.normal(size=(48, V)).astype(np.float32)
    enc = _enc_np(k, r, hidden=8, seed=1, alpha=0.2)
    inits = {seed + 17 * j: {"w": (rng.normal(size=(F, V)) * 0.3).astype(
        np.float32)} for j in range(r)}

    def j_init(key):                       # PRNGKey(n) holds n in word 1
        return jax.tree.map(jnp.asarray, inits[int(np.asarray(key)[-1])])

    jsch = jscheme.get_scheme("learned", k=k, r=r, hidden=8,
                              enc_params=jax.tree.map(jnp.asarray, enc))
    jpp, jtrained, jloss = jparity._train_joint(
        jsch, _linear_j, j_init, x, fx, epochs=1, seed=seed, batch=8)
    tsch = tscheme.get_scheme("learned", k=k, r=r, hidden=8, device="cpu",
                              enc_params=params_from_numpy(enc, "cpu"))
    tpp, ttrained, tloss = tparity._train_joint(
        tsch, _linear_t, lambda s: params_from_numpy(inits[s], "cpu"), x,
        fx, epochs=1, seed=seed, batch=8)
    assert len(tloss) == len(jloss) == 3
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _close_trees(ttrained.enc_params, jtrained.enc_params, rtol=1e-4)
    _close_trees(tpp, jpp, rtol=1e-4)
    assert isinstance(ttrained, tlearned.LearnedScheme)
    assert not torch.equal(ttrained.enc_params["alpha"],
                           tsch.enc_params["alpha"])


def test_learned_provisioning_publishes_the_trained_scheme():
    """``train_parity_models(scheme="learned")`` takes the joint path and
    returns the scheme that carries the trained encoder."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    W = {"w": torch.tensor(rng.normal(size=(6, 3)).astype(np.float32))}
    pp, scheme = tparity.train_parity_models(
        W, _linear_t, lambda s: {"w": torch.zeros(6, 3)}, x, k=2,
        scheme="learned", epochs=2, batch=8, device="cpu")
    assert isinstance(scheme, tlearned.LearnedScheme) and len(pp) == 1
    assert tscheme.scheme_capabilities(scheme).trainable
    assert float(scheme.enc_params["alpha"]) != 0.0
    assert not torch.equal(pp[0]["w"], torch.zeros(6, 3))
    assert not pp[0]["w"].requires_grad


# --------------------------------------------------------------- fisher ---
def _mlp_pair(seed, img=(4, 4, 1)):
    p, _ = jcnn.build("mlp", jax.random.PRNGKey(seed), image_shape=img)
    return p, params_from_numpy(_np(p), "cpu")


def test_fisher_coeffs_equal_reference():
    for k, r in ((2, 1), (3, 2), (4, 3)):
        port = tscheme.get_scheme("fisher", k=k, r=r, device="cpu")
        ref = jscheme.get_scheme("fisher", k=k, r=r)
        np.testing.assert_array_equal(port.host_coeffs,
                                      np.asarray(ref.coeffs))
        np.testing.assert_array_equal(
            tfisher._row_normalized_vandermonde(k, r),
            jfisher._row_normalized_vandermonde(k, r))


def test_diag_fisher_matches_reference():
    """Per-example gradients by torch.func.vmap(grad) against jax.vmap(grad)
    on a carried MLP and the same calibration batch: every leaf within 1e-4
    relative of its largest entry."""
    jp, tp = _mlp_pair(0)
    x = np.random.default_rng(1).normal(size=(16, 4, 4, 1)).astype(
        np.float32)
    want = _np(jfisher.diag_fisher(jcnn.mlp_fwd, jp, x))
    got = params_to_numpy(tfisher.diag_fisher(tcnn.mlp_fwd, tp, x))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))
    assert all(float(np.abs(b).max()) > 0 for b in jax.tree.leaves(want))


def test_fisher_provisioning_matches_reference():
    """Two distinct members, r = 2 rows: the Fisher-weighted merges agree
    within 1e-5, with zero gradient steps (init_fn is never called)."""
    (j0, t0), (j1, t1) = _mlp_pair(1), _mlp_pair(2)
    x = np.random.default_rng(0).normal(size=(80, 4, 4, 1)).astype(
        np.float32)

    def boom(_):
        raise AssertionError("fisher provisioning must not train")

    jpp, _ = jparity.train_parity_models([j0, j1], jcnn.mlp_fwd, boom, x,
                                         k=2, r=2, scheme="fisher")
    tpp, scheme = tparity.train_parity_models(
        [t0, t1], tcnn.mlp_fwd, boom, x, k=2, r=2, scheme="fisher",
        device="cpu")
    assert isinstance(scheme, tfisher.FisherScheme) and len(tpp) == 2
    for got, want in zip(tpp, jpp):
        _close_trees(got, want, rtol=1e-5, atol=1e-5)


def test_fisher_identical_members_merge_to_themselves():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    W = {"w": torch.tensor(rng.normal(size=(6, 3)).astype(np.float32))}
    pp, _ = tparity.train_parity_models(W, _linear_t, None, x, k=3, r=2,
                                        scheme="fisher", device="cpu")
    for p in pp:
        np.testing.assert_allclose(p["w"].numpy(), W["w"].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="per member"):
        tparity.train_parity_models([W, W, W], _linear_t, None, x, k=2,
                                    scheme="fisher", device="cpu")


def test_weighted_merge_matches_reference():
    rng = np.random.default_rng(4)
    trees = [{"a": rng.normal(size=(3, 2)).astype(np.float32),
              "b": [rng.normal(size=(4,)).astype(np.float32)]}
             for _ in range(3)]
    weights = [{"a": np.float32(c), "b": [rng.random(4).astype(np.float32)]}
               for c in (0.2, 0.3, 0.5)]
    want = jio.weighted_merge(trees, weights)
    got = tio.weighted_merge([params_from_numpy(t, "cpu") for t in trees],
                             [params_from_numpy(w, "cpu") for w in weights])
    _close_trees(got, want, rtol=1e-6)
    bf = tio.weighted_merge([{"w": torch.ones(2, dtype=torch.bfloat16)}] * 2,
                            [{"w": torch.tensor(1.0)}] * 2)
    assert bf["w"].dtype == torch.bfloat16


# --------------------------------------------------------------- invnet ---
def _coupling_np(seed=3, hidden=8, n_layers=2):
    return _np(jinv.init_coupling_params(hidden=hidden, seed=seed,
                                         n_layers=n_layers))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("f", [6, 7, 16])
def test_invnet_g_roundtrip_and_matches_reference(f, backend):
    cp = _coupling_np()
    port = tinv.InvNetScheme(k=2, backend=backend, device="cpu",
                             coupling_params=params_from_numpy(cp, "cpu"))
    ref = jinv.InvNetScheme(k=2, coupling_params=cp)
    x = np.random.default_rng(f).normal(size=(5, f)).astype(np.float32)
    y = port.g_forward(x)
    assert not np.allclose(to_host(y), x)
    _close(y, ref.g_forward(x))
    _close(port.g_inverse(y), x)
    _close(port.g_inverse(x), ref.g_inverse(x))
    fresh = tinv.init_coupling_params(hidden=8, seed=1, n_layers=3,
                                      device="cpu")
    assert len(fresh) == 3 and fresh[0]["w2"].shape == (8, 1)
    back = tinv.InvNetScheme(k=2, backend=backend, device="cpu",
                             coupling_params=fresh)
    _close(back.g_inverse(back.g_forward(x)), x)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,r,shape", [(2, 1, (4, 16)), (2, 2, (4, 16)),
                                       (3, 2, (2, 5, 5, 1)), (2, 1, (9,))])
def test_invnet_encode_with_carried_couplings(k, r, shape, backend):
    cp = _coupling_np(seed=k + r)
    q = np.random.default_rng(1).normal(size=(k,) + shape).astype(
        np.float32)
    port = tscheme.get_scheme("invnet", k=k, r=r, backend=backend,
                              device="cpu").with_params(
        params_from_numpy(cp, "cpu"))
    got = port.encode(q)
    assert tuple(got.shape) == (r,) + shape
    for jb in ("jnp", "pallas"):
        ref = jscheme.get_scheme("invnet", k=k, r=r, backend=jb,
                                 coupling_params=cp)
        _close(got, ref.encode(jnp.asarray(q)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_invnet_decode_bit_exact_on_integer_substrate(backend):
    """Integer couplings, queries and head keep every fp32 operation exact,
    so the port's parity query, its output and the rebuilt members are
    bit-equal to the reference's and to the true member outputs."""
    coupling = [{"w1": [2.0, -1.0], "b1": [1.0, 3.0], "w2": [[1.0], [2.0]]},
                {"w1": [-1.0, 1.0], "b1": [0.0, 2.0], "w2": [[2.0], [1.0]]}]
    coupling = [{n: np.asarray(v, np.float32) for n, v in layer.items()}
                for layer in coupling]
    port = tinv.InvNetScheme(k=2, r=1, backend=backend, device="cpu",
                             coupling_params=coupling)
    ref = jinv.InvNetScheme(k=2, r=1, coupling_params=coupling)
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, size=(2, 3, 8)).astype(np.float32)
    W = rng.integers(-3, 4, size=(8, 4)).astype(np.float32)

    def F(q):
        return to_host(port.g_forward(q)) @ W

    parity = to_host(port.encode(x))
    assert np.array_equal(parity, np.asarray(ref.encode(jnp.asarray(x))))
    assert np.array_equal(to_host(port.g_inverse(port.g_forward(x[0]))),
                          x[0])
    outs = np.stack([F(x[0]), F(x[1])])
    p_out = F(parity[0])
    assert np.array_equal(p_out, outs[0] + outs[1])
    for j in range(2):
        rec = to_host(port.decode_one(p_out, outs, j))
        assert np.array_equal(rec, outs[j]), f"member {j}"


def test_invnet_encode_takes_the_unfused_fallback():
    """invnet overrides encode, so fused_parity_outputs must serve it by
    encode + per-row forward even on an MLP parity substrate."""
    _, tp = _mlp_pair(0, img=(4, 4, 1))
    scheme = tscheme.get_scheme("invnet", k=2, device="cpu")
    q = np.random.default_rng(0).normal(size=(2, 3, 4, 4, 1)).astype(
        np.float32)
    got = tparity.fused_parity_outputs(scheme, q, [tp], tcnn.mlp_fwd)
    want = tcnn.mlp_fwd(tp, scheme.encode(q)[0])[None]
    assert torch.equal(got, want)
    tparity._FORCE_FUSED = True
    try:
        with pytest.raises(ValueError, match="not fusable"):
            tparity.fused_parity_outputs(scheme, q, [tp], tcnn.mlp_fwd)
    finally:
        tparity._FORCE_FUSED = None


# ----------------------------------------------------- checkpoint interop --
def test_reference_npz_loads_into_port_tensors(tmp_path):
    """A learned encoder and a Fisher-merged MLP written by the reference's
    ``checkpoint.io.save`` load with the port's ``load`` into equal tensors;
    the port's own ``save`` loads back with the reference's ``load``."""
    enc = jlearned.init_encoder_params(2, 2, 16, seed=4, alpha=0.3)
    (j0, _), (j1, _) = _mlp_pair(1), _mlp_pair(2)
    x = np.random.default_rng(0).normal(size=(32, 4, 4, 1)).astype(
        np.float32)
    merged, _ = jparity.train_parity_models([j0, j1], jcnn.mlp_fwd, None, x,
                                            k=2, scheme="fisher")
    for name, tree in (("enc", enc), ("fisher", merged[0])):
        path = str(tmp_path / f"{name}.npz")
        jio.save(path, tree, step=3, extra={"scheme": name})
        like = jax.tree.map(lambda a: torch.zeros(np.shape(a)), _np(tree))
        got, meta = tio.load(path, like)
        assert meta["step"] == 3 and meta["extra"]["scheme"] == name
        for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                        jax.tree.leaves(_np(tree))):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        back = str(tmp_path / f"{name}_port.npz")
        tio.save(back, got, step=4)
        again, meta2 = jio.load(back, like=tree)
        assert meta2["step"] == 4 and \
            meta2["n_leaves"] == len(jax.tree.leaves(tree))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), again, _np(tree))
    scheme = tscheme.get_scheme("learned", k=2, r=2, device="cpu")
    loaded, _ = tio.load(str(tmp_path / "enc.npz"), scheme.enc_params)
    q = np.random.default_rng(2).normal(size=(2, 3, 5)).astype(np.float32)
    _close(scheme.with_params(loaded).encode(q), jscheme.get_scheme(
        "learned", k=2, r=2, enc_params=enc).encode(jnp.asarray(q)))
    with pytest.raises(ValueError, match="leaves"):
        tio.load(str(tmp_path / "enc.npz"), {"w": torch.zeros(1)})


# ------------------------------------------------------- singular decodes --
def _finite_like_reference(got, want):
    got, want = to_host(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,r", [("sum", 1), ("sum", 2),
                                    ("approxifer", 1), ("approxifer", 2)])
def test_unrecoverable_decode_is_non_finite_like_reference(name, r):
    """More members missing than the code can rebuild: where the
    reference's solve returns non-finite values the port returns them in
    the same positions (``solve_ex`` + ``torch.where``), where it does not
    raise."""
    rng = np.random.default_rng(9)
    outs = rng.normal(size=(2, 3, 4)).astype(np.float32)
    po = rng.normal(size=(r, 3, 4)).astype(np.float32)
    ref = jscheme.get_scheme(name, k=2, r=r)
    miss = np.ones(2, bool)
    for pa in (np.ones(r, bool), np.zeros(r, bool)):
        want = np.asarray(ref.decode(jnp.asarray(po), jnp.asarray(outs),
                                     jnp.asarray(miss), jnp.asarray(pa)))
        if name == "sum" and r == 1 and pa.all():
            assert not np.isfinite(want).any()     # the singular system
        for backend in BACKENDS:
            port = tscheme.get_scheme(name, k=2, r=r, backend=backend,
                                      device="cpu")
            _finite_like_reference(port.decode(po, outs, miss, pa), want)


def test_unrecoverable_decode_many_and_linear_decoder():
    """The batched decode: one unrecoverable group among recoverable ones
    goes non-finite alone, as in the reference; the same for
    ``codes.LinearDecoder``."""
    from repro.core.codes import LinearDecoder as JDecoder
    from repro_torch.core.codes import LinearDecoder as TDecoder
    rng = np.random.default_rng(3)
    G = 4
    outs = rng.normal(size=(G, 2, 3, 5)).astype(np.float32)
    po = rng.normal(size=(G, 1, 3, 5)).astype(np.float32)
    masks = np.array([[True, True], [False, True], [True, False],
                      [False, False]])
    ref = jscheme.get_scheme("sum", k=2)
    want = np.asarray(ref.decode_many(jnp.asarray(po), jnp.asarray(outs),
                                      jnp.asarray(masks)))
    assert not np.isfinite(want[0]).any() and np.isfinite(want[1:]).all()
    for backend in BACKENDS:
        port = tscheme.get_scheme("sum", k=2, backend=backend, device="cpu")
        _finite_like_reference(port.decode_many(po, outs, masks), want)
    jd = JDecoder(k=2)
    td = TDecoder(k=2, device="cpu")
    _finite_like_reference(
        td.decode(po[0], outs[0], np.array([True, True])),
        jd.decode(jnp.asarray(po[0]), jnp.asarray(outs[0]),
                  jnp.asarray([True, True])))
