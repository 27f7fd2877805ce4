"""CUDA kernel wrapper: ParM subtraction decode —
``recon = (F_P(P) - sum_i avail_c_i * F(X_i)) * inv_c``.

Replaces ``repro/kernels/parity_decode.py:parity_decode`` (a Pallas TPU
kernel) with ``csrc/parity_kernels.cu:decode_kernel``.  The availability mask
folds the "which output is missing" choice into data, so one kernel serves
every missing index.  The k + 1 coefficients are host values: the C entry
copies them into the kernel's launch parameters, so a call is one launch,
with no device op to build them and no copy to the card."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("parity_decode")

MAX_K = 32          # csrc/parity_kernels.cu:kMaxDecodeK


def host_floats(x, name):
    """``x`` (numpy, a list, a Python or numpy scalar, or a CPU tensor) as a
    float32 numpy array.  A CUDA tensor raises: reading it would add a
    device sync to every decode."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError(
                f"{name}: coefficients must be host values (numpy, a list "
                f"or a CPU tensor), got a tensor on {x.device}; pass the "
                f"host copy (e.g. the scheme's host_coeffs) so that the "
                f"decode adds no device sync")
        x = x.detach().numpy()
    return np.asarray(x, dtype=np.float32)


def parity_decode(parity_out, outputs, avail_coeffs, inv_c):
    """parity_out [B, V]; outputs [k, B, V] (same dtype, CUDA, contiguous);
    avail_coeffs [k] (0 at the missing index) and inv_c, host values (see
    ``host_floats``).  Returns [B, V] in parity_out's dtype."""
    k = outputs.shape[0]
    avail = host_floats(avail_coeffs, "parity_decode")
    if outputs.ndim != 3 or parity_out.shape != outputs.shape[1:] or \
            avail.shape != (k,):
        raise ValueError(
            f"parity_decode: parity_out [B, V], outputs [k, B, V], "
            f"avail_coeffs [k]; got {tuple(parity_out.shape)}, "
            f"{tuple(outputs.shape)}, {avail.shape}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"parity_decode: the kernel takes 1 <= k <= "
                         f"{MAX_K}, got k={k}")
    if outputs.dtype != parity_out.dtype:
        raise TypeError("parity_decode: parity_out and outputs must share "
                        "one dtype")
    cvec = np.empty(k + 1, np.float32)       # the kernel's launch parameters
    cvec[:k] = avail
    cvec[k] = host_floats(inv_c, "parity_decode")
    _build.require_cuda("parity_decode", parity_out, outputs)
    code = _build.dtype_code(parity_out.dtype)
    out = torch.empty_like(parity_out)
    lib = _build.library()
    dev = parity_out.device
    with _build.device_guard(dev):
        rc = lib.repro_parity_decode(
            parity_out.data_ptr(), outputs.data_ptr(), cvec.ctypes.data,
            out.data_ptr(), k, parity_out.numel(), code, _build.stream(dev))
    _build.check(rc, "parity_decode")
    if parity_out.numel():
        launches.add()
    return out
