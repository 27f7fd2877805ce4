"""CUDA kernel wrapper: fused parity encode -> first forward matmul.

    out[j, b, v] = sum_f ( sum_i C[j, i] * X[i, b, f] ) * W[j, f, v]

Replaces ``repro/kernels/fused_encode_forward.py:fused_encode_forward`` (a
Pallas TPU kernel) with ``csrc/parity_kernels.cu:fused_kernel``: a tiled
SIMT fp32 GEMM whose A-operand load does the encode, so the [r, B, F]
encoded queries never reach device memory.  The ragged F tail is zero-masked
on both operands."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("fused_encode_forward")

_MAX_B = 65535 * 32            # gridDim.y limit times the batch tile


def fused_encode_forward(queries, coeffs, weights):
    """queries [k, B, F]; coeffs [r, k] fp32; weights [r, F, V] (fp32 or
    bf16 each, CUDA, contiguous) -> [r, B, V] in the queries' dtype."""
    if queries.ndim != 3 or coeffs.ndim != 2 or weights.ndim != 3 or \
            coeffs.shape[1] != queries.shape[0] or \
            weights.shape[:2] != (coeffs.shape[0], queries.shape[2]):
        raise ValueError(
            f"fused_encode_forward: queries [k, B, F], coeffs [r, k], "
            f"weights [r, F, V]; got {tuple(queries.shape)}, "
            f"{tuple(coeffs.shape)}, {tuple(weights.shape)}")
    if coeffs.dtype != torch.float32:
        raise TypeError("fused_encode_forward: coeffs must be float32")
    _build.require_cuda("fused_encode_forward", queries, coeffs, weights)
    cx = _build.dtype_code(queries.dtype)
    cw = _build.dtype_code(weights.dtype)
    k, B, F = queries.shape
    r, _, V = weights.shape
    if B > _MAX_B:
        raise ValueError(f"fused_encode_forward: B={B} exceeds {_MAX_B}")
    out = torch.empty((r, B, V), dtype=queries.dtype, device=queries.device)
    lib = _build.library()
    with _build.device_guard(queries.device):
        rc = lib.repro_fused_encode_forward(
            queries.data_ptr(), coeffs.data_ptr(), weights.data_ptr(),
            out.data_ptr(), k, r, B, F, V, cx, cw,
            _build.stream(queries.device))
    _build.check(rc, "fused_encode_forward")
    if out.numel():
        launches.add()
    return out
