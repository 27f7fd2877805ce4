"""CUDA kernel wrapper: batched multi-group parity decode, plus the batched
least-squares decode in plain PyTorch.

Under load, a batch-atomic completion makes SEVERAL coding groups
decode-ready at once; this decodes ALL recoverable groups in one launch by
stacking the per-group ``(parity_out, outputs, coeffs)`` triples:

    recon[g] = ( P[g] - sum_i avail_c[g, i] * F(X_i)[g] ) * inv_c[g]

Replaces ``repro/kernels/multigroup_decode.py:multigroup_decode`` (a Pallas
TPU kernel) with ``csrc/parity_kernels.cu:mg_decode_kernel``.  The missing
indices and coefficients are host values: the C entry copies them into the
kernel's launch parameters (shared coefficients as ``c`` and ``1 / c`` with
one index byte per group, per-group ones as their rows), so a call is one
launch, with no device op to build the rows and no copy to the card, up to
``MAX_GROUPS`` groups with shared coefficients and ``MAX_ROWS // (k + 1)``
with per-group ones; more groups take one launch per ``chunks`` range.

``multigroup_lstsq`` is the r>1 / multi-missing generalization, plain
PyTorch as it was plain XLA in the reference: the masked least-squares decode
of ALL stacked groups as batched normal equations and one batched solve (a
singular group gives NaN, as in the reference, instead of raising).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codes import solve_or_nan
from repro_torch.kernels import _build
from repro_torch.kernels.parity_decode import host_floats

launches = _build.LaunchCounter("multigroup_decode")

MAX_TABLE = 256          # csrc/parity_kernels.cu:kMgTableFloats, 2k shared
MAX_GROUPS = 1024        # csrc/parity_kernels.cu:kMgGroups, per launch
MAX_ROWS = 8128          # csrc/parity_kernels.cu:kMgRowFloats, per launch


def host_indices(missing_idxs, G, k):
    """The G missing indices as an int64 numpy array; a CUDA tensor raises
    ``TypeError`` (reading it back would add a device sync to every
    decode), an index outside [0, k) ``ValueError``."""
    if isinstance(missing_idxs, torch.Tensor):
        if missing_idxs.device.type != "cpu":
            raise TypeError(
                f"multigroup_decode: missing indices must be host values "
                f"(numpy, a list or a CPU tensor), got a tensor on "
                f"{missing_idxs.device}")
        missing_idxs = missing_idxs.numpy()
    idx = np.asarray(missing_idxs, np.int64).reshape(G)
    if G and not 0 <= idx.min() <= idx.max() < k:
        raise ValueError(f"multigroup_decode: missing indices must lie in "
                         f"[0, {k}), got {idx.min()}..{idx.max()}")
    return idx


def _coeffs(coeffs, G, k):
    c = host_floats(coeffs, "multigroup_decode")
    if c.shape not in ((k,), (G, k)):
        raise ValueError(f"multigroup_decode: coeffs [k] or [G, k] with "
                         f"G={G}, k={k}, got {c.shape}")
    return c


def coeff_rows(missing_idxs, coeffs, G, k):
    """The [G, k + 1] fp32 decode rows on the host, by the reference's
    formula: row g is ``c_g * [i != j_g]`` with ``1 / c_g[j_g]`` appended;
    coeffs [k] (shared) or [G, k] (per group), host values.  JAX multiplies
    by a boolean mask as a select, so the missing index holds +0 (whatever
    the sign of c_j), bit for bit as there; the kernel still multiplies the
    missing member's placeholder output by it, so a NaN or Inf there
    reaches the result, as in the reference."""
    idx = host_indices(missing_idxs, G, k)
    c = np.broadcast_to(_coeffs(coeffs, G, k), (G, k))
    avail = np.where(np.arange(k)[None, :] != idx[:, None], c,
                     np.float32(0.0))
    inv = np.float32(1.0) / np.take_along_axis(c, idx[:, None], axis=1)
    return np.concatenate([avail, inv], axis=1)


def shared_table(coeffs):
    """Shared coefficients as the kernel takes them: ``c_0..c_{k-1}`` then
    ``1/c_0..1/c_{k-1}`` (fp32); group g's row is ``c`` with 0 at its
    missing index j and ``1/c_j`` appended, ``coeff_rows``' row bit for
    bit."""
    c = host_floats(coeffs, "multigroup_decode")
    return np.concatenate([c, np.float32(1.0) / c])


def chunks(G, k, per_group):
    """The [g0, g1) group ranges of a call over G groups, one launch each:
    ``MAX_GROUPS`` groups with shared coefficients (2k words of
    ``MAX_TABLE``, k <= 128), as many groups as their rows of k + 1 fit in
    ``MAX_ROWS`` words with per-group ones (2,709 at k = 2)."""
    words, cap = (k + 1, MAX_ROWS) if per_group else (2 * k, MAX_TABLE)
    if words > cap:
        raise ValueError(f"multigroup_decode: {words} coefficient words "
                         f"exceed one launch's {cap}")
    per = MAX_ROWS // words if per_group else MAX_GROUPS
    return [(g0, min(g0 + per, G)) for g0 in range(0, G, per)]


def multigroup_decode(parity_outs, outputs, missing_idxs, coeffs,
                      checked=False):
    """parity_outs [G, B, V]; outputs [G, k, B, V] (same dtype, CUDA,
    contiguous); missing_idxs [G] ints and coeffs [k] (shared) or [G, k]
    (per group), host values (``host_indices``).  Returns reconstructions
    [G, B, V], from one launch per ``chunks`` range.  ``checked`` launches
    from the bounds-checked build and counts nothing."""
    if outputs.ndim != 4 or parity_outs.shape != \
            (outputs.shape[0],) + tuple(outputs.shape[2:]):
        raise ValueError(
            f"multigroup_decode: parity_outs [G, B, V], outputs [G, k, B, V]; "
            f"got {tuple(parity_outs.shape)}, {tuple(outputs.shape)}")
    G, k, B, V = outputs.shape
    idx = host_indices(missing_idxs, G, k)
    c = _coeffs(coeffs, G, k)
    if outputs.dtype != parity_outs.dtype:
        raise TypeError("multigroup_decode: parity_outs and outputs share one "
                        "dtype")
    _build.require_cuda("multigroup_decode", parity_outs, outputs)
    code = _build.dtype_code(parity_outs.dtype)
    n = B * V
    out = torch.empty_like(parity_outs)
    if not out.numel():
        return out
    per_group = c.ndim == 2
    plan = chunks(G, k, per_group)
    table = coeff_rows(idx, c, G, k) if per_group else shared_table(c)
    sel = idx.astype(np.uint8)
    lib = _build.library(checked)
    dev = parity_outs.device
    es = parity_outs.element_size()
    p, o, dst = parity_outs.data_ptr(), outputs.data_ptr(), out.data_ptr()
    with _build.device_guard(dev):
        for g0, g1 in plan:
            words = table[g0:g1] if per_group else table
            rc = lib.repro_multigroup_decode(
                p + g0 * n * es, o + g0 * k * n * es, words.ctypes.data,
                sel[g0:].ctypes.data, dst + g0 * n * es, g1 - g0, k, n,
                int(per_group), code, _build.stream(dev))
            _build.check(rc, "multigroup_decode")
            if not checked:
                launches.add()
    return out


def multigroup_lstsq(coeffs, parity_outs, outputs, missing_masks,
                     parity_avail):
    """Batched masked least-squares decode over G stacked groups.

    coeffs [r, k] (shared — one scheme decodes the whole batch);
    parity_outs [G, r, ...]; outputs [G, k, ...]; missing_masks [G, k] bool;
    parity_avail [G, r] bool.  Returns [G, k, ...] with reconstructed rows at
    the missing positions (the normal-equations math of
    ``LinearScheme.decode``, batched so every group solves in one call)."""
    coeffs = coeffs.float()
    r, k = coeffs.shape
    outs = outputs.float()
    G = outs.shape[0]
    tail = (1,) * (outs.ndim - 2)
    pa = parity_avail.float()                                    # [G, r]
    mm = missing_masks.bool()                                    # [G, k]
    C = coeffs[None] * pa[:, :, None]                            # [G, r, k]
    po = parity_outs.float() * pa.reshape((G, r) + tail)
    avail = (~mm).float()
    rhs = po - torch.einsum("grk,gk...->gr...", C * avail[:, None, :], outs)
    M = C * mm.float()[:, None, :]                               # [G, r, k]
    eye = torch.eye(k, dtype=torch.float32, device=M.device)
    gram = M.transpose(1, 2) @ M + 1e-9 * eye                    # [G, k, k]
    mt_rhs = torch.einsum("grk,gr...->gk...", M, rhs)
    sol = solve_or_nan(gram, mt_rhs.reshape(G, k, -1)).reshape(mt_rhs.shape)
    return torch.where(mm.reshape((G, k) + tail), sol, outs)
