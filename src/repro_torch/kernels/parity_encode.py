"""CUDA kernel wrapper: ParM parity encoding — P_j = sum_i C[j, i] * X_i for
each parity row j.

Replaces ``repro/kernels/parity_encode.py:parity_encode`` (a Pallas TPU
kernel, one parity row per call) with ``csrc/parity_kernels.cu:
encode_kernel``, which writes all r rows in one launch.  The r x k
coefficients are host values: the C entry copies them into the kernel's
launch parameters, so a call is one launch, with no device op to build them
and no copy to the card."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.parity_decode import host_floats

launches = _build.LaunchCounter("parity_encode")

MAX_COEFFS = 256    # csrc/parity_kernels.cu:kMaxEncodeCoeffs, r * k


def parity_encode(queries, coeffs, checked=False):
    """queries [k, B, F] (fp32 or bf16, CUDA, contiguous); coeffs [k] or
    [r, k], host values (see ``parity_decode.host_floats``) -> [B, F] or
    [r, B, F] in the queries' dtype, from one launch.  ``checked`` launches
    from the bounds-checked build and counts nothing."""
    c = host_floats(coeffs, "parity_encode")
    if queries.ndim != 3 or c.ndim not in (1, 2) or \
            c.shape[-1] != queries.shape[0]:
        raise ValueError(f"parity_encode: queries [k, B, F] and coeffs [k] or "
                         f"[r, k], got {tuple(queries.shape)}, {c.shape}")
    rows = np.ascontiguousarray(c.reshape(-1, c.shape[-1]))
    k, B, F = queries.shape
    r = rows.shape[0]
    if not 1 <= r * k <= MAX_COEFFS:
        raise ValueError(f"parity_encode: the kernel takes r * k <= "
                         f"{MAX_COEFFS} coefficients, got k={k}, r={r}")
    _build.require_cuda("parity_encode", queries)
    code = _build.dtype_code(queries.dtype)
    out = torch.empty((r, B, F), dtype=queries.dtype, device=queries.device)
    lib = _build.library(checked)
    with _build.device_guard(queries.device):
        rc = lib.repro_parity_encode(
            queries.data_ptr(), rows.ctypes.data, out.data_ptr(), k, r,
            B * F, code, _build.stream(queries.device))
    _build.check(rc, "parity_encode")
    if B * F and not checked:
        launches.add()
    return out if c.ndim == 2 else out[0]
