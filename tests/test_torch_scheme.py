"""The port's coding schemes (``repro_torch.core.scheme``) against the JAX
package's, on the same seeded numpy inputs: ``sum`` (r=1 and r=2),
``concat``, ``replication`` and ``approx_backup``, both backends of the port
(``torch`` and ``kernels``, whose CPU path is the kernels' plain versions)
against the reference's ``jnp``, every missing index and missing mask, plus
the registry's names and errors and ``recoverable_rows``.  fp32 tolerance
2e-5 scaled by the reduction length, as in the reference's own tests."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheme as jscheme
from repro_torch.core import scheme as tscheme
from repro_torch.core.codes import (LinearDecoder, SumEncoder, make_code,
                                    vandermonde)

CASES = [("sum", 1), ("sum", 2), ("concat", 1), ("replication", None),
         ("approx_backup", None)]
BACKENDS = ("torch", "kernels")


def _pair(name, k, r, backend):
    ref = jscheme.get_scheme(name, k=k, r=r)
    port = tscheme.get_scheme(name, k=k, r=r, backend=backend, device="cpu")
    return ref, port


def _close(got, want, tol=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _queries(name, k, rng, B=3):
    shape = (k, B, 4, 4, 1) if name == "concat" else (k, B, 6)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,r", CASES)
def test_encode_and_coeffs(name, r, backend):
    k = 1 if name == "approx_backup" else 3
    ref, port = _pair(name, k, r, backend)
    assert (port.k, port.r, port.name) == (ref.k, ref.r, ref.name)
    assert port.device == "cpu" and port.backend == backend
    np.testing.assert_array_equal(port.host_coeffs, np.asarray(ref.coeffs))
    np.testing.assert_array_equal(port.coeffs.numpy(), np.asarray(ref.coeffs))
    q = _queries(name, k, np.random.default_rng(0))
    _close(port.encode(q), ref.encode(jnp.asarray(q)))
    _close(port(torch.tensor(q)), ref(jnp.asarray(q)))
    assert tscheme.scheme_capabilities(port) == \
        tscheme.Capabilities(**vars(jscheme.scheme_capabilities(ref)))
    assert tscheme.decode_cost(port, 2) == jscheme.decode_cost(ref, 2)
    assert tscheme.encode_cost(port) == jscheme.encode_cost(ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("r", [1, 2])
def test_encode_forward(r, backend):
    k, B, F, V = 3, 4, 50, 7
    ref, port = _pair("sum", k, r, backend)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(k, B, 5, 10)).astype(np.float32)
    W = rng.normal(size=(r, F, V)).astype(np.float32)
    _close(port.encode_forward(q, W), ref.encode_forward(q, W), 2e-5 * F)
    # a shared 2d first-layer matrix broadcasts across rows
    _close(port.encode_forward(q, W[0]), ref.encode_forward(q, W[0]),
           2e-5 * F)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,r", [("sum", 1), ("concat", 1),
                                    ("replication", None),
                                    ("approx_backup", None)])
@pytest.mark.parametrize("batched", [False, True])
def test_decode_one_every_missing_index(name, r, backend, batched):
    k = 1 if name == "approx_backup" else 3
    ref, port = _pair(name, k, r, backend)
    rng = np.random.default_rng(1)
    tail = (2, 10) if batched else (10,)
    outs = rng.normal(size=(k,) + tail).astype(np.float32)
    po = rng.normal(size=tail).astype(np.float32)
    for j in range(k):
        _close(port.decode_one(po, outs, j),
               ref.decode_one(jnp.asarray(po), jnp.asarray(outs), j), 2e-5 * k)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tail", [(10,), (3, 10)])
def test_decode_one_many(backend, tail):
    k, G = 4, 6
    ref, port = _pair("sum", k, 1, backend)
    rng = np.random.default_rng(2)
    po = rng.normal(size=(G,) + tail).astype(np.float32)
    outs = rng.normal(size=(G, k) + tail).astype(np.float32)
    idxs = np.arange(G) % k
    want = ref.decode_one_many(jnp.asarray(po), jnp.asarray(outs), idxs)
    _close(port.decode_one_many(po, outs, idxs), want, 2e-5 * k)
    for g in range(G):                  # == G per-group decodes
        _close(port.decode_one(po[g], outs[g], int(idxs[g])),
               np.asarray(want)[g], 2e-5 * k)


def _spy(monkeypatch, name):
    """Count the calls of ``kernels.ops.<name>`` and keep their arguments."""
    from repro_torch.kernels import ops
    calls, real = [], getattr(ops, name)

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("tail", [(), (6,), (3, 6)])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_kernels_encode_is_one_op_call(monkeypatch, r, tail):
    """Under backend="kernels" an encode of all r parity rows is one
    ``parity_encode_op`` call with the scheme's host coefficients, and
    equals the reference scheme's encode."""
    k = 3
    ref, port = _pair("sum", k, r, "kernels")
    calls = _spy(monkeypatch, "parity_encode_op")
    q = np.random.default_rng(r).normal(size=(k,) + tail).astype(np.float32)
    got = port.encode(q)
    assert tuple(got.shape) == (r,) + tail
    _close(got, ref.encode(jnp.asarray(q)), 2e-5 * k)
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0][1], port.host_coeffs)


@pytest.mark.parametrize("form", [np.asarray, list, torch.tensor])
def test_kernels_decode_one_many_keeps_indices_on_host(monkeypatch, form):
    """Under backend="kernels" decode_one_many hands its missing indices to
    one ``multigroup_decode_op`` call as it got them (host values), with
    the scheme's host coefficients, and equals the reference's."""
    k, G = 3, 5
    ref, port = _pair("sum", k, 1, "kernels")
    calls = _spy(monkeypatch, "multigroup_decode_op")
    rng = np.random.default_rng(4)
    po = rng.normal(size=(G, 2, 10)).astype(np.float32)
    outs = rng.normal(size=(G, k, 2, 10)).astype(np.float32)
    idxs = form([int(i) for i in rng.integers(0, k, G)])
    want = ref.decode_one_many(jnp.asarray(po), jnp.asarray(outs),
                               np.asarray(idxs))
    _close(port.decode_one_many(po, outs, idxs), want, 2e-5 * k)
    assert len(calls) == 1 and calls[0][2] is idxs
    np.testing.assert_array_equal(calls[0][3], port.host_coeffs[0])


def _masks(k, r):
    """Every missing mask with 1..r missing rows."""
    for n in range(1, r + 1):
        for rows in itertools.combinations(range(k), n):
            m = np.zeros(k, bool)
            m[list(rows)] = True
            yield m


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,r", CASES)
def test_decode_every_missing_mask(name, r, backend):
    k = 1 if name == "approx_backup" else 3
    ref, port = _pair(name, k, r, backend)
    rng = np.random.default_rng(3)
    po = rng.normal(size=(ref.r, 2, 5)).astype(np.float32)
    outs = rng.normal(size=(k, 2, 5)).astype(np.float32)
    for mask in _masks(k, ref.r):
        want = ref.decode(jnp.asarray(po), jnp.asarray(outs),
                          jnp.asarray(mask))
        _close(port.decode(po, outs, mask), want, 1e-4 * k)
        pa = np.ones(ref.r, bool)
        pa[-1] = mask.sum() >= ref.r      # lose a surplus parity only
        want = ref.decode(jnp.asarray(po), jnp.asarray(outs),
                          jnp.asarray(mask), jnp.asarray(pa))
        _close(port.decode(po, outs, mask, pa), want, 1e-4 * k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_many(backend):
    k, r, B, V = 3, 2, 2, 11
    ref, port = _pair("sum", k, r, backend)
    rng = np.random.default_rng(4)
    masks = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 1]], bool)
    pa = np.array([[1, 1], [1, 1], [1, 1], [1, 0]], bool)
    G = len(masks)
    po = rng.normal(size=(G, r, B, V)).astype(np.float32)
    outs = rng.normal(size=(G, k, B, V)).astype(np.float32)
    _close(port.decode_many(po, outs, masks, pa),
           ref.decode_many(jnp.asarray(po), jnp.asarray(outs), masks, pa),
           1e-4 * k)
    _close(port.decode_many(po, outs, masks),
           ref.decode_many(jnp.asarray(po), jnp.asarray(outs), masks),
           1e-4 * k)


def test_batched_surface_is_linear_family_only():
    for name in ("replication", "approx_backup"):
        s = tscheme.get_scheme(name, k=2, device="cpu")
        assert not hasattr(type(s), "decode_one_many"), name
        assert not hasattr(type(s), "decode_many"), name
    for name in ("sum", "concat"):
        assert hasattr(type(tscheme.get_scheme(name, k=2, device="cpu")),
                       "decode_one_many")


@pytest.mark.parametrize("name,r", [("sum", 1), ("sum", 2),
                                    ("replication", None)])
def test_recoverable_rows(name, r):
    k = 3
    ref, port = _pair(name, k, r, "kernels")
    for mask in itertools.product([False, True], repeat=k):
        for pa in itertools.product([False, True], repeat=ref.r):
            np.testing.assert_array_equal(
                tscheme.recoverable_rows(port, mask, pa),
                jscheme.recoverable_rows(ref, mask, pa))


def test_registry_names_and_errors():
    assert tscheme.list_schemes() == ["approx_backup", "approxifer",
                                      "concat", "fisher", "invnet",
                                      "learned", "replication", "sum"]
    assert tscheme.available_schemes() == tscheme.list_schemes()
    assert tscheme.list_schemes() == jscheme.list_schemes()
    with pytest.raises(KeyError, match="unknown coding scheme"):
        tscheme.get_scheme("nope", k=2, device="cpu")
    with pytest.raises(ValueError, match="requires k"):
        tscheme.get_scheme("sum", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tscheme.get_scheme("sum", k=2, backend="jnp", device="cpu")
    with pytest.raises(ValueError, match="r=1 only"):
        tscheme.get_scheme("concat", k=2, r=2, device="cpu")
    with pytest.raises(ValueError, match="r == k"):
        tscheme.ReplicationScheme(k=2, r=3, device="cpu")
    with pytest.raises(ValueError, match="k == 1"):
        tscheme.ApproxBackupScheme(k=2, device="cpu")
    s = tscheme.get_scheme("sum", k=2, device="cpu")
    assert tscheme.get_scheme(s, k=2, r=1, backend="kernels",
                              device="cpu") is s
    for bad in ({"k": 3}, {"r": 2}, {"backend": "torch"},
                {"device": "cuda"}):
        with pytest.raises(ValueError, match="requested"):
            tscheme.get_scheme(s, **bad)
    # approx_backup owns its group size: the budget k is not checked
    ab = tscheme.get_scheme("approx_backup", k=4, device="cpu")
    assert ab.k == 1 and tscheme.get_scheme(ab, k=4) is ab
    with pytest.raises(TypeError, match="not a CodingScheme"):
        tscheme.get_scheme(object())
    with pytest.raises(ValueError, match="already registered"):
        tscheme.register_scheme("sum", tscheme.ConcatScheme)
    tscheme.register_scheme("sum", tscheme.LinearScheme)   # same: a no-op
    with pytest.raises(TypeError, match="removed"):
        make_code(2)
    with pytest.warns(DeprecationWarning):
        assert tscheme.ApproxBackupScheme.fixes_k is True


def test_codes_match_reference():
    """The standalone encoder/decoder classes and the Vandermonde rows."""
    from repro.core import codes as jcodes
    np.testing.assert_array_equal(vandermonde(4, 3), jcodes.vandermonde(4, 3))
    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 2, 5)).astype(np.float32)
    _close(SumEncoder(3, 2, device="cpu")(q),
           jcodes.SumEncoder(3, 2)(jnp.asarray(q)))
    outs = rng.normal(size=(3, 2, 5)).astype(np.float32)
    po = rng.normal(size=(2, 2, 5)).astype(np.float32)
    dec, jdec = LinearDecoder(3, 2, device="cpu"), jcodes.LinearDecoder(3, 2)
    for j in range(3):
        _close(dec.decode_one(po[0], outs, j),
               jdec.decode_one(jnp.asarray(po[0]), jnp.asarray(outs), j))
    mask = np.array([True, False, True])
    _close(dec.decode(po, outs, mask),
           jdec.decode(jnp.asarray(po), jnp.asarray(outs), jnp.asarray(mask)),
           1e-4)
