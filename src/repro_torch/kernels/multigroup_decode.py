"""CUDA kernel wrapper: batched multi-group parity decode, plus the batched
least-squares decode in plain PyTorch.

Under load, a batch-atomic completion makes SEVERAL coding groups
decode-ready at once; this decodes ALL recoverable groups in one launch by
stacking the per-group ``(parity_out, outputs, coeffs)`` triples:

    recon[g] = ( P[g] - sum_i avail_c[g, i] * F(X_i)[g] ) * inv_c[g]

Replaces ``repro/kernels/multigroup_decode.py:multigroup_decode`` (a Pallas
TPU kernel) with ``csrc/parity_kernels.cu:mg_decode_kernel``.

``multigroup_lstsq`` is the r>1 / multi-missing generalization, plain
PyTorch as it was plain XLA in the reference: the masked least-squares decode
of ALL stacked groups as batched normal equations and one batched solve (a
singular group gives NaN, as in the reference, instead of raising).
"""
from __future__ import annotations

import torch

from repro_torch.core.codes import solve_or_nan
from repro_torch.kernels import _build

launches = _build.LaunchCounter("multigroup_decode")


def multigroup_decode(parity_outs, outputs, cmat):
    """parity_outs [G, B, V]; outputs [G, k, B, V] (same dtype, CUDA,
    contiguous); cmat [G, k+1] fp32 — per-group availability-masked coeffs
    (0 at the missing index) with 1/c_missing appended.  Returns
    reconstructions [G, B, V]."""
    if outputs.ndim != 4 or parity_outs.shape != \
            (outputs.shape[0],) + tuple(outputs.shape[2:]) or \
            cmat.shape != (outputs.shape[0], outputs.shape[1] + 1):
        raise ValueError(
            f"multigroup_decode: parity_outs [G, B, V], outputs [G, k, B, V], "
            f"cmat [G, k+1]; got {tuple(parity_outs.shape)}, "
            f"{tuple(outputs.shape)}, {tuple(cmat.shape)}")
    if outputs.dtype != parity_outs.dtype or cmat.dtype != torch.float32:
        raise TypeError("multigroup_decode: parity_outs and outputs share one "
                        "dtype; cmat is float32")
    _build.require_cuda("multigroup_decode", parity_outs, outputs, cmat)
    code = _build.dtype_code(parity_outs.dtype)
    G, k, B, V = outputs.shape
    out = torch.empty_like(parity_outs)
    lib = _build.library()
    with _build.device_guard(parity_outs.device):
        rc = lib.repro_multigroup_decode(
            parity_outs.data_ptr(), outputs.data_ptr(), cmat.data_ptr(),
            out.data_ptr(), G, k, B * V, code,
            _build.stream(parity_outs.device))
    _build.check(rc, "multigroup_decode")
    if out.numel():
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
