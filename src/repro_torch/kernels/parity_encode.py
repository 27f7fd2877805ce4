"""CUDA kernel wrapper: ParM parity encoding — P = sum_i c_i * X_i.

Replaces ``repro/kernels/parity_encode.py:parity_encode`` (a Pallas TPU
kernel).  The kernel (``csrc/parity_kernels.cu:encode_kernel``) is a
memory-bound elementwise reduction over the small coding dimension k: one
thread per output element, the k-loop in fp32 registers."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("parity_encode")


def parity_encode(queries, coeffs):
    """queries [k, B, F] (fp32 or bf16, CUDA, contiguous); coeffs [k] fp32
    -> [B, F] in the queries' dtype."""
    if queries.ndim != 3 or coeffs.shape != (queries.shape[0],):
        raise ValueError(f"parity_encode: queries [k, B, F] and coeffs [k], "
                         f"got {tuple(queries.shape)}, {tuple(coeffs.shape)}")
    if coeffs.dtype != torch.float32:
        raise TypeError("parity_encode: coeffs must be float32")
    _build.require_cuda("parity_encode", queries, coeffs)
    code = _build.dtype_code(queries.dtype)
    k, B, F = queries.shape
    out = torch.empty((B, F), dtype=queries.dtype, device=queries.device)
    lib = _build.library()
    with _build.device_guard(queries.device):
        rc = lib.repro_parity_encode(
            queries.data_ptr(), coeffs.data_ptr(), out.data_ptr(), k, B * F,
            code, _build.stream(queries.device))
    _build.check(rc, "parity_encode")
    if B * F:
        launches.add()
    return out
