"""The port's coded hot-path ops (``repro_torch.kernels``) against the JAX
package's (``repro.kernels.ops``, Pallas in interpret mode on the CPU).

The same numpy inputs, made from a seed, go through both.  On the CPU the
port's ops run the kernels' plain PyTorch versions (CPU tensors), so these
tests hold the plain versions and the ops' shape handling, missing-index
folding and dtype rules to the reference; the CUDA kernels themselves are
held against the same plain versions on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).  Tolerances are the reference tests': fp32
2e-5, bf16 2e-2, the fused kernel scaled by sqrt(F*k), decodes by k.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.multigroup_decode import multigroup_lstsq as j_lstsq
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_encode_forward import (BK, BM, BN, WARPS,
                                                     fused_plan, fused_slices)
from repro_torch.kernels.multigroup_decode import multigroup_lstsq

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt):
    return 2e-2 if dt == "bf16" else 2e-5


def _both(a, dt="f32"):
    """One numpy array as a JAX array and a CPU tensor of the same dtype
    (both round fp32 -> bf16 to nearest even, so the inputs are equal)."""
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _close(got, want, atol, rtol=None):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(want, np.float32),
        atol=atol, rtol=atol if rtol is None else rtol)


@pytest.mark.parametrize("k,B,F,dt", [
    (2, 4, 512, "f32"), (3, 1, 128, "f32"), (4, 8, 1000, "bf16"),
    (6, 2, 257, "f32"), (2, 1, 784, "f32"),
])
def test_parity_encode(k, B, F, dt):
    rng = np.random.default_rng(k * 31 + B)
    jq, tq = _both(rng.normal(size=(k, B, F)).astype(np.float32), dt)
    c = np.arange(1.0, k + 1.0, dtype=np.float32)
    want = jops.parity_encode_op(jq, jnp.asarray(c))
    got = ops.parity_encode_op(tq, torch.tensor(c))
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    _close(got, want, _tol(dt))
    _close(ref.parity_encode_ref(tq, torch.tensor(c)),
           jref.parity_encode_ref(jq, jnp.asarray(c)), _tol(dt))


def test_parity_encode_trailing_feature_shape():
    rng = np.random.default_rng(0)
    jq, tq = _both(rng.normal(size=(2, 3, 4, 6, 1)).astype(np.float32))
    c = np.array([1.0, 2.0], np.float32)
    got = ops.parity_encode_op(tq, torch.tensor(c))
    assert tuple(got.shape) == (3, 4, 6, 1)
    _close(got, jops.parity_encode_op(jq, jnp.asarray(c)), 2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_parity_encode_all_rows_in_one_call(r, dt):
    """[r, k] coefficients in one call equal the reference's encode row by
    row (its op takes one [k] row per call)."""
    k, B, F = 3, 2, 257
    rng = np.random.default_rng(10 * r)
    jq, tq = _both(rng.normal(size=(k, B, F, 1)).astype(np.float32), dt)
    C = rng.normal(size=(r, k)).astype(np.float32)
    got = ops.parity_encode_op(tq, C)
    assert got.dtype == tq.dtype and tuple(got.shape) == (r, B, F, 1)
    for j in range(r):
        _close(got[j], jops.parity_encode_op(jq, jnp.asarray(C[j])), _tol(dt))
    _close(ref.parity_encode_ref(tq.reshape(k, B, F), torch.tensor(C)),
           np.stack([jref.parity_encode_ref(jq.reshape(k, B, F),
                                            jnp.asarray(C[j]))
                     for j in range(r)]), _tol(dt))


@pytest.mark.parametrize("coeffs", [np.ones(2, np.float32), [1.0, 2.0],
                                    torch.tensor([1.0, 2.0])])
def test_parity_encode_host_coefficient_forms(coeffs):
    """numpy, a list and a CPU tensor are host coefficients; a tensor on
    another device raises TypeError (on the card it would cost a sync)."""
    q = torch.ones(2, 3, 5)
    want = ref.parity_encode_ref(q, torch.tensor(np.asarray(coeffs,
                                                            np.float32)))
    _close(ops.parity_encode_op(q, coeffs), want.numpy(), 0.0)
    with pytest.raises(TypeError, match="host values"):
        ops.parity_encode_op(q, torch.ones(2, device="meta"))


@pytest.mark.parametrize("k,r,fits", [(256, 1, True), (20, 12, True),
                                      (257, 1, False), (129, 2, False)])
def test_parity_encode_coefficient_cap(k, r, fits):
    """The kernel takes any k with r * k <= 256 coefficients (its launch
    parameters); past that the wrapper raises ValueError, before it looks
    at the device (a CPU tensor then raises for not being on the card)."""
    from repro_torch.kernels.parity_encode import parity_encode
    q = torch.ones(k, 1, 3)
    C = np.ones((r, k), np.float32)
    with pytest.raises(ValueError, match="CUDA tensors" if fits else
                       "r \\* k <= 256"):
        parity_encode(q, C)


@pytest.mark.parametrize("k,B,V,dt", [
    (2, 4, 100, "f32"), (4, 2, 1000, "f32"), (3, 8, 513, "bf16"),
    (2, 1, 10, "f32"),
])
def test_parity_decode(k, B, V, dt):
    rng = np.random.default_rng(7 + k)
    jo, to = _both(rng.normal(size=(k, B, V)).astype(np.float32), dt)
    jp, tp = _both(rng.normal(size=(B, V)).astype(np.float32), dt)
    c = np.arange(1.0, k + 1.0, dtype=np.float32)
    for j in range(k):
        want = jops.parity_decode_op(jp, jo, j, coeffs=jnp.asarray(c))
        got = ops.parity_decode_op(tp, to, j, coeffs=torch.tensor(c))
        assert got.dtype == tp.dtype
        _close(got, want, _tol(dt) * k, 2e-2)
        avail = c * (np.arange(k) != j)
        _close(ref.parity_decode_ref(tp, to, torch.tensor(avail),
                                     1.0 / float(c[j])),
               jref.parity_decode_ref(jp, jo, jnp.asarray(avail),
                                      1.0 / float(c[j])),
               _tol(dt) * k, 2e-2)
    # coeffs=None is the plain sum code
    _close(ops.parity_decode_op(tp, to, 0),
           jops.parity_decode_op(jp, jo, 0), _tol(dt) * k, 2e-2)


@pytest.mark.parametrize("kind", ["numpy", "list", "tensor"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_parity_decode_host_coeffs(k, kind):
    """B3's coefficients are computed on the host: for numpy, list and CPU
    tensor coefficients (non-unit, mixed sign) and every missing index the
    op equals the JAX package's op, and is bit-identical to the plain
    version fed today's device-computed coefficients."""
    rng = np.random.default_rng(100 + k)
    c = (rng.uniform(0.5, 2.0, k) * rng.choice([-1.0, 1.0], k)).astype(
        np.float32)
    jo, to = _both(rng.normal(size=(k, 3, 10)).astype(np.float32))
    jp, tp = _both(rng.normal(size=(3, 10)).astype(np.float32))
    coeffs = {"numpy": c, "list": c.tolist(), "tensor": torch.tensor(c)}[kind]
    for j in range(k):
        got = ops.parity_decode_op(tp, to, j, coeffs=coeffs)
        _close(got, jops.parity_decode_op(jp, jo, j, coeffs=jnp.asarray(c)),
               _tol("f32") * k, 2e-2)
        tc = torch.tensor(c)
        today = ref.parity_decode_ref(tp, to, tc * (torch.arange(k) != j),
                                      1.0 / tc[j])
        assert torch.equal(got, today)


def test_parity_decode_rejects_device_coeffs():
    """Coefficients off the host raise TypeError (reading them back would
    add a device sync to every decode)."""
    with pytest.raises(TypeError, match="host"):
        ops.parity_decode_op(torch.ones(3, 5), torch.ones(2, 3, 5), 0,
                             coeffs=torch.ones(2, device="meta"))


@pytest.mark.parametrize("k,r,B,F,V,dt", [
    (2, 1, 4, 512, 128, "f32"),
    (3, 1, 5, 300, 130, "f32"),      # nothing 128-aligned
    (2, 3, 8, 1024, 257, "f32"),     # trailing partial V block
    (4, 2, 1, 129, 64, "f32"),       # trailing partial F block, B=1
    (4, 2, 8, 1000, 100, "bf16"),
])
def test_fused_encode_forward(k, r, B, F, V, dt):
    rng = np.random.default_rng(k * 97 + r * 13 + F)
    jq, tq = _both(rng.normal(size=(k, B, F)).astype(np.float32), dt)
    C = rng.normal(size=(r, k)).astype(np.float32)
    jw, tw = _both(rng.normal(size=(r, F, V)).astype(np.float32), dt)
    want = jops.fused_encode_forward_op(jq, jnp.asarray(C), jw)
    got = ops.fused_encode_forward_op(tq, torch.tensor(C), tw)
    assert tuple(got.shape) == (r, B, V) and got.dtype == tq.dtype
    tol = _tol(dt) * np.sqrt(F * k)
    _close(got, want, tol)
    _close(ref.fused_encode_forward_ref(tq, torch.tensor(C), tw),
           jref.fused_encode_forward_ref(jq, jnp.asarray(C), jw), tol)


def test_fused_encode_forward_trailing_feature_shape():
    """Image-shaped queries flatten to F inside the op."""
    rng = np.random.default_rng(0)
    jq, tq = _both(rng.normal(size=(3, 2, 4, 6, 2)).astype(np.float32))
    C = np.array([[1.0, 2.0, 3.0]], np.float32)
    jw, tw = _both(rng.normal(size=(1, 48, 10)).astype(np.float32))
    _close(ops.fused_encode_forward_op(tq, torch.tensor(C), tw),
           jops.fused_encode_forward_op(jq, jnp.asarray(C), jw), 2e-5 * 16)


def test_fused_encode_forward_no_features():
    """F = 0: every output is an empty sum."""
    got = ops.fused_encode_forward_op(torch.ones(2, 3, 0),
                                      torch.ones(1, 2), torch.ones(1, 0, 5))
    assert torch.equal(got, torch.zeros(1, 3, 5))


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("F", [1, 129, 300, 784, 1000])
def test_fused_slices_cover_f_once(F, S):
    """B2's cluster of S CTAs takes every F index exactly once, each rank's
    slice starting on a stage boundary (ranks beyond F's steps empty)."""
    slices = fused_slices(F, S)
    assert len(slices) == S
    seen = np.zeros(F, int)
    for f0, f1 in slices:
        assert 0 <= f0 <= f1 <= F and (f0 == f1 or f0 % BK == 0)
        seen[f0:f1] += 1
    assert (seen == 1).all()
    assert [a for a, _ in slices[1:]] == [b for _, b in slices[:-1]]


# clusters of S CTAs an H100 80GB HBM3 holds at once for B2's fp32 TMA
# instance at k = 2 (cudaOccupancyMaxActiveClusters, as chip_smoke.py
# prints them)
H100_CLUSTERS = {1: 396, 2: 198, 3: 124, 4: 92, 5: 69, 6: 62, 7: 47, 8: 45}


def test_fused_plan_fills_the_card():
    """At the A_d shape the launch puts at least 8 warps on each of 132 SMs
    with a portable cluster, in one wave, and its grid is whole clusters of
    output tiles."""
    bm, bn, S, grid = fused_plan(2, 1, 1000, 784, 200, H100_CLUSTERS)
    assert 1 <= S <= 8
    assert grid[0] * grid[1] * grid[2] * WARPS >= 8 * 132
    assert grid[0] * grid[1] * grid[2] <= S * H100_CLUSTERS[S]
    assert grid == (S * -(-200 // bn), -(-1000 // bm), 1)


@pytest.mark.parametrize("B,V,S", [(200, 200, 8), (3000, 64, 7),
                                   (960, 256, 6), (1000, 200, 5),
                                   (1280, 256, 4), (1600, 256, 3),
                                   (2400, 256, 2), (4000, 200, 1),
                                   (100000, 200, 1)])
def test_fused_plan_one_wave(B, V, S):
    """The cluster size is the largest whose clusters all fit at once (one
    wave), and 1 where none does."""
    got = fused_plan(2, 1, B, 784, V, H100_CLUSTERS)[2]
    assert got == S
    tiles = -(-B // BM) * -(-V // BN)
    assert S == 1 or tiles <= H100_CLUSTERS[S]
    assert S == 8 or tiles > H100_CLUSTERS[S + 1]


@pytest.mark.parametrize("S", [3, 7, 8])
@pytest.mark.parametrize("k,r,B,F,V,dt", [
    (2, 1, 4, 512, 128, "f32"), (3, 1, 5, 300, 130, "f32"),
    (2, 3, 8, 1024, 257, "f32"), (4, 2, 1, 129, 64, "f32"),
    (4, 2, 8, 1000, 100, "bf16"),
])
def test_fused_split_ref_matches_reference(k, r, B, F, V, dt, S):
    """The plain model of B2's summation order (per-slice partials summed in
    rank order) against the JAX package's op."""
    rng = np.random.default_rng(k * 97 + r * 13 + F)
    jq, tq = _both(rng.normal(size=(k, B, F)).astype(np.float32), dt)
    C = rng.normal(size=(r, k)).astype(np.float32)
    jw, tw = _both(rng.normal(size=(r, F, V)).astype(np.float32), dt)
    got = ref.fused_encode_forward_split_ref(tq, torch.tensor(C), tw, S)
    assert tuple(got.shape) == (r, B, V) and got.dtype == tq.dtype
    _close(got, jops.fused_encode_forward_op(jq, jnp.asarray(C), jw),
           _tol(dt) * np.sqrt(F * k))


@pytest.mark.parametrize("H,r,B,F,dt", [
    (8, 1, 4, 512, "f32"), (16, 2, 1, 128, "f32"), (16, 3, 2, 257, "f32"),
    (32, 2, 8, 1000, "bf16"),
])
def test_learned_project(H, r, B, F, dt):
    """B5's plain version and op against the reference's interpret-mode op
    (the cases of the reference's ``test_learned_project``, tolerance 4x
    the dtype's), including the 4-D trailing feature shape."""
    rng = np.random.default_rng(H * 13 + r)
    jh, th = _both(rng.normal(size=(H, B, F)).astype(np.float32), dt)
    w = rng.normal(size=(H, r)).astype(np.float32)
    want = jops.learned_project_op(jh, jnp.asarray(w))
    got = ops.learned_project_op(th, torch.tensor(w))
    assert got.dtype == th.dtype and tuple(got.shape) == want.shape
    _close(got, want, _tol(dt) * 4)
    _close(ref.learned_project_ref(th, torch.tensor(w)), want, _tol(dt) * 4)
    jh4, th4 = _both(rng.normal(size=(H, B, 4, 6)).astype(np.float32))
    got4 = ops.learned_project_op(th4, torch.tensor(w))
    assert tuple(got4.shape) == (r, B, 4, 6)
    _close(got4, jops.learned_project_op(jh4, jnp.asarray(w)), 2e-4)


@pytest.mark.parametrize("k,r,shape", [(2, 1, (3, 8)), (3, 2, (1, 4, 4, 1)),
                                       (4, 2, (2, 130)), (2, 2, (9, 5))])
def test_berrut_encode(k, r, shape):
    """B6 (B5 with W = C^T) against the reference's op, over the shapes of
    the reference's approxifer tests (tolerance 1e-4, theirs)."""
    rng = np.random.default_rng(3 * k + r)
    jq, tq = _both(rng.normal(size=(k,) + shape).astype(np.float32))
    c = rng.normal(size=(r, k)).astype(np.float32)
    want = jops.berrut_encode_op(jq, jnp.asarray(c))
    got = ops.berrut_encode_op(tq, torch.tensor(c))
    assert tuple(got.shape) == (r,) + shape
    _close(got, want, 1e-4)


def test_berrut_encode_unbatched_vector():
    """The approxifer encode of an unbatched [k, F] group on both packages'
    kernel route."""
    from repro.core.scheme import get_scheme as j_get_scheme
    from repro_torch.core.scheme import get_scheme
    q = np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32)
    want = j_get_scheme("approxifer", k=3, backend="pallas").encode(
        jnp.asarray(q))
    got = get_scheme("approxifer", k=3, device="cpu").encode(q)
    assert tuple(got.shape) == (1, 7)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("G,k,B,V", [(1, 2, 1, 9), (5, 3, 4, 100),
                                     (4, 4, 2, 257), (20, 2, 1, 10)])
def test_multigroup_decode(G, k, B, V):
    """Shared and per-group coefficients, every missing index."""
    rng = np.random.default_rng(G * 7 + k)
    jp, tp = _both(rng.normal(size=(G, B, V)).astype(np.float32))
    jo, to = _both(rng.normal(size=(G, k, B, V)).astype(np.float32))
    idxs = np.arange(G) % k
    for c in (np.arange(1.0, k + 1.0, dtype=np.float32),
              rng.normal(size=(G, k)).astype(np.float32) + 2.0):
        want = jops.multigroup_decode_op(jp, jo, idxs, jnp.asarray(c))
        got = ops.multigroup_decode_op(tp, to, idxs, torch.tensor(c))
        _close(got, want, 2e-5 * k)


def test_multigroup_decode_no_batch_axis_and_ref():
    G, k, V = 3, 2, 40
    rng = np.random.default_rng(0)
    jp, tp = _both(rng.normal(size=(G, V)).astype(np.float32))
    jo, to = _both(rng.normal(size=(G, k, V)).astype(np.float32))
    idxs = np.array([0, 1, 0])
    c = np.array([2.0, 3.0], np.float32)
    got = ops.multigroup_decode_op(tp, to, idxs, torch.tensor(c))
    assert tuple(got.shape) == (G, V)
    _close(got, jops.multigroup_decode_op(jp, jo, idxs, jnp.asarray(c)), 2e-5)
    cg = np.broadcast_to(c, (G, k)).copy()
    avail = cg * (np.arange(k)[None] != idxs[:, None])
    inv = 1.0 / np.take_along_axis(cg, idxs[:, None], 1)
    cmat = np.concatenate([avail, inv], 1).astype(np.float32)
    _close(ref.multigroup_decode_ref(tp[:, None], to[:, :, None],
                                     torch.tensor(cmat)),
           jref.multigroup_decode_ref(jp[:, None], jo[:, :, None],
                                      jnp.asarray(cmat)), 2e-5)


def _reference_rows(idxs, c, G, k):
    """The reference op's [G, k+1] coefficient matrix
    (``repro.kernels.ops.multigroup_decode_op``, written out in JAX)."""
    idx = jnp.asarray(idxs)
    c = jnp.asarray(c, jnp.float32)
    if c.ndim == 1:
        c = jnp.broadcast_to(c[None], (G, k))
    avail = c * (jnp.arange(k)[None, :] != idx[:, None])
    inv = 1.0 / jnp.take_along_axis(c, idx[:, None], axis=1)
    return np.asarray(jnp.concatenate([avail, inv], axis=1))


@pytest.mark.parametrize("shared", [True, False])
def test_multigroup_coeff_rows_bit_equal_to_reference(shared):
    """The host rows equal the reference's formula bit for bit, a negative
    coefficient at the missing index included (JAX's product with a
    boolean mask is a select: +0 there, not -0); so do the rows the kernel
    selects from shared coefficients (c with 0 at j, and 1/c_j)."""
    from repro_torch.kernels.multigroup_decode import coeff_rows, shared_table
    G, k = 12, 4
    rng = np.random.default_rng(5)
    c = rng.uniform(0.3, 3.0, (k,) if shared else (G, k)).astype(np.float32)
    c *= rng.choice([-1.0, 1.0], c.shape).astype(np.float32)
    idxs = rng.integers(0, k, G)
    got = coeff_rows(idxs, c, G, k)
    want = _reference_rows(idxs, c, G, k)
    assert got.dtype == np.float32 and got.shape == (G, k + 1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (np.broadcast_to(c, (G, k))[np.arange(G), idxs] < 0).any()
    for form in (list(idxs), torch.tensor(idxs)):
        np.testing.assert_array_equal(coeff_rows(form, c, G, k), got)
    if shared:
        words = shared_table(c)
        sel = np.arange(k)[None, :] == idxs[:, None]
        kernel = np.concatenate([np.where(sel, np.float32(0.0), words[:k]),
                                 words[k + idxs][:, None]], axis=1)
        np.testing.assert_array_equal(kernel.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("shared", [True, False])
def test_multigroup_decode_placeholder_propagates(bad, shared):
    """A NaN or Inf in the missing member's placeholder output gives NaN in
    the same places as the reference (c_j * 0 is not skipped)."""
    G, k, B, V = 6, 3, 2, 5
    rng = np.random.default_rng(3)
    po = rng.normal(size=(G, B, V)).astype(np.float32)
    outs = rng.normal(size=(G, k, B, V)).astype(np.float32)
    idxs = np.arange(G) % k
    outs[np.arange(G), idxs, 0, :2] = bad
    c = np.arange(1.0, k + 1.0, dtype=np.float32) if shared else \
        rng.normal(size=(G, k)).astype(np.float32) + 3.0
    want = np.asarray(jops.multigroup_decode_op(
        jnp.asarray(po), jnp.asarray(outs), idxs, jnp.asarray(c)))
    got = ops.multigroup_decode_op(torch.tensor(po), torch.tensor(outs),
                                   idxs, c).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    _close(torch.tensor(got[keep]), want[keep], 2e-5 * k)


@pytest.mark.parametrize("G,k,per_group,launches", [
    (1, 2, False, 1), (1000, 2, False, 1), (1024, 2, False, 1),
    (1025, 2, False, 2), (6000, 2, False, 6), (3000, 128, False, 3),
    (1000, 2, True, 1), (2709, 2, True, 1), (2710, 2, True, 2),
    (6000, 2, True, 3), (1000, 7, True, 1), (1000, 16, True, 3),
    (40, 255, True, 2)])
def test_multigroup_chunk_plan(G, k, per_group, launches):
    """Groups past one launch's capacity go in further launches: 1024
    groups a launch with shared coefficients (2k of 256 words, k <= 128),
    as many groups as their rows of k + 1 fit in 8128 words with per-group
    ones (2709 at k = 2, so the A_d path's 1000 is one launch up to k = 7);
    the ranges cover [0, G) in order."""
    from repro_torch.kernels.multigroup_decode import (MAX_GROUPS, MAX_ROWS,
                                                       chunks)
    plan = chunks(G, k, per_group)
    assert len(plan) == launches
    assert plan[0][0] == 0 and plan[-1][1] == G
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    if per_group:
        assert all(0 < (g1 - g0) * (k + 1) <= MAX_ROWS for g0, g1 in plan)
    else:
        assert all(0 < g1 - g0 <= MAX_GROUPS for g0, g1 in plan)


def test_multigroup_decode_rejects_device_indices_and_coeffs():
    """Indices or coefficients on a device raise TypeError (on the card
    reading them back would cost a sync per decode); too wide a row for one
    launch, or a missing index outside [0, k), raises ValueError."""
    from repro_torch.kernels.multigroup_decode import chunks
    po, outs = torch.ones(4, 5), torch.ones(4, 2, 5)
    with pytest.raises(TypeError, match="host values"):
        ops.multigroup_decode_op(po, outs, torch.zeros(4, dtype=torch.long,
                                                       device="meta"), [1, 1])
    with pytest.raises(TypeError, match="host values"):
        ops.multigroup_decode_op(po, outs, [0, 1, 0, 1],
                                 torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="coefficient words"):
        chunks(1, 129, False)
    with pytest.raises(ValueError, match="coefficient words"):
        chunks(1, 8128, True)
    with pytest.raises(ValueError, match="missing indices"):
        ops.multigroup_decode_op(po, outs, [0, 1, 2, 1], [1, 1])


@pytest.mark.parametrize("k,r", [(3, 2), (4, 3)])
def test_multigroup_lstsq(k, r):
    """Batched masked least squares, varied masks and a straggling parity."""
    from repro_torch.core.codes import vandermonde
    rng = np.random.default_rng(k + r)
    C = vandermonde(k, r).astype(np.float32)
    G, B, V = 4, 2, 11
    masks = np.zeros((G, k), bool)
    for g in range(G):
        masks[g, rng.choice(k, size=1 + g % r, replace=False)] = True
    pa = np.ones((G, r), bool)
    pa[-1, -1] = masks[-1].sum() >= r        # lose a surplus parity only
    po = rng.normal(size=(G, r, B, V)).astype(np.float32)
    outs = rng.normal(size=(G, k, B, V)).astype(np.float32)
    want = j_lstsq(jnp.asarray(C), jnp.asarray(po), jnp.asarray(outs),
                   jnp.asarray(masks), jnp.asarray(pa))
    got = multigroup_lstsq(torch.tensor(C), torch.tensor(po),
                           torch.tensor(outs), torch.tensor(masks),
                           torch.tensor(pa))
    _close(got, want, 1e-4 * k)


def test_cpu_ops_launch_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    before = {n: c.value for n, c in ops.counters().items()}
    q = torch.ones(2, 3, 5)
    ops.parity_encode_op(q, torch.ones(2))
    ops.parity_decode_op(torch.ones(3, 5), q, 1)
    ops.multigroup_decode_op(torch.ones(4, 5), torch.ones(4, 2, 5),
                             np.array([0, 1, 0, 1]), torch.ones(2))
    ops.fused_encode_forward_op(q, torch.ones(1, 2), torch.ones(1, 5, 7))
    ops.learned_project_op(q, torch.ones(2, 3))
    ops.berrut_encode_op(q, torch.ones(3, 2))
    att = torch.ones(1, 4, 2, 32)
    ops.flash_attention_op(att, att, att)
    ops.decode_attention_op(att[:, 0], att, att, 2)
    assert {n: c.value for n, c in ops.counters().items()} == before
    assert set(before) == {"parity_encode", "parity_decode",
                           "multigroup_decode", "fused_encode_forward",
                           "learned_project", "berrut_encode",
                           "flash_attention", "decode_attention"}


def test_other_devices_raise():
    """Only CPU (plain version) and CUDA (kernel) tensors are dispatched."""
    q = torch.empty(2, 3, 5, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.parity_encode_op(q, torch.ones(2, device="meta"))


def test_kernel_wrappers_reject_cpu_tensors():
    """A kernel wrapper never runs a plain version: handed a CPU tensor it
    raises before touching the build."""
    from repro_torch.kernels import (berrut_encoder, decode_attention,
                                     flash_attention, fused_encode_forward,
                                     learned_encoder, multigroup_decode,
                                     parity_decode, parity_encode)
    q = torch.ones(2, 3, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        parity_encode.parity_encode(q, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        parity_decode.parity_decode(torch.ones(3, 5), q, torch.ones(2),
                                    torch.tensor(1.0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        multigroup_decode.multigroup_decode(torch.ones(4, 3, 5),
                                            torch.ones(4, 2, 3, 5),
                                            [0, 1, 0, 1], torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_encode_forward.fused_encode_forward(q, torch.ones(1, 2),
                                                  torch.ones(1, 5, 7))
    with pytest.raises(ValueError, match="CUDA tensors"):
        learned_encoder.learned_project(q, torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        berrut_encoder.berrut_encode(q, torch.ones(3, 2))
    att = torch.ones(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(att, att, att)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention.decode_attention(
            att[:, 0].contiguous(), att, att,
            torch.tensor(2, dtype=torch.int32))


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference():
    """An AST walk over every module of the port and chip_smoke.py: no
    import of jax (or jaxlib) and none of the JAX package ``repro``."""
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(_port_sources()) > 20
    assert not bad, bad


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    """With no card and no explicit device="cpu", entry points raise."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.parity import train_parity_models
    from repro_torch.core.scheme import get_scheme
    from repro_torch.models.cnn import build
    from repro_torch.serving.api import DeploymentSpec, deploy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_scheme("sum", k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build("mlp", 0, image_shape=(4, 4, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.ones((2, 2))})
    params, fwd = build("mlp", 0, image_shape=(4, 4, 1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy(DeploymentSpec(fwd=fwd, params=params), engine="threads")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_parity_models(params, fwd, None, np.zeros((4, 4, 4, 1)), k=2)
    # ... and the explicit CPU request works
    assert get_scheme("sum", k=2, device="cpu").coeffs.device.type == "cpu"
