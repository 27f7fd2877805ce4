"""CUDA kernel wrapper: ParM subtraction decode —
``recon = (F_P(P) - sum_i avail_c_i * F(X_i)) * inv_c``.

Replaces ``repro/kernels/parity_decode.py:parity_decode`` (a Pallas TPU
kernel).  It launches the G = 1 case of the multigroup decode kernel
(``csrc/parity_kernels.cu:mg_decode_kernel``); the availability mask folds the
"which output is missing" choice into data, so one kernel serves every
missing index."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("parity_decode")


def parity_decode(parity_out, outputs, avail_coeffs, inv_c):
    """parity_out [B, V]; outputs [k, B, V] (same dtype, CUDA, contiguous);
    avail_coeffs [k] fp32 (0 at the missing index); inv_c fp32 scalar tensor.
    Returns [B, V] in parity_out's dtype."""
    k = outputs.shape[0]
    if outputs.ndim != 3 or parity_out.shape != outputs.shape[1:] or \
            avail_coeffs.shape != (k,):
        raise ValueError(
            f"parity_decode: parity_out [B, V], outputs [k, B, V], "
            f"avail_coeffs [k]; got {tuple(parity_out.shape)}, "
            f"{tuple(outputs.shape)}, {tuple(avail_coeffs.shape)}")
    if outputs.dtype != parity_out.dtype:
        raise TypeError("parity_decode: parity_out and outputs must share "
                        "one dtype")
    cvec = torch.cat([avail_coeffs.float(),
                      torch.as_tensor(inv_c, dtype=torch.float32,
                                      device=avail_coeffs.device).reshape(1)])
    _build.require_cuda("parity_decode", parity_out, outputs, cvec)
    code = _build.dtype_code(parity_out.dtype)
    out = torch.empty_like(parity_out)
    lib = _build.library()
    with torch.cuda.device(parity_out.device):
        rc = lib.repro_multigroup_decode(
            parity_out.data_ptr(), outputs.data_ptr(), cvec.data_ptr(),
            out.data_ptr(), 1, k, parity_out.numel(), code,
            _build.stream(parity_out.device))
    _build.check(rc, "parity_decode")
    if parity_out.numel():
        launches.add()
    return out
