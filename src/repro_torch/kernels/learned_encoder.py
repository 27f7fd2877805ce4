"""CUDA kernel wrapper: learned-encoder final projection — the linear map
from the encoder MLP's hidden activations to the r parity rows,

    out[j] = sum_h W[h, j] * H[h]          (H [H, B, F], W [H, r])

Replaces ``repro/kernels/learned_encoder.py:learned_project`` (a Pallas TPU
kernel) with ``csrc/parity_kernels.cu:project_kernel``: a memory-bound
reduction over the small leading axis, streamed at the HBM rate: each thread
owns 16 bytes of every input row, issues its loads of up to 16 rows before
its first multiply-add, and accumulates all r rows (up to 8 per launch row
group) in fp32 registers, so each input value is read once.
``berrut_encoder.py`` launches the same kernel with ``W = C^T``, through
``launch`` below, under its own counter."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("learned_project")

_ROWS = 8                      # kProjRows: output rows per launch row group
_MAX_SMEM_FLOATS = 12288       # the W columns of one row group: 48 KB


def smem_rows(r):
    """The W columns one row group keeps in shared memory: r rounded up to
    the kernel instance's 1, 2, 4 or 8 rows."""
    return next(n for n in (1, 2, 4, _ROWS) if min(r, _ROWS) <= n)


def launch(h, w, name):
    """Validate, allocate and launch the projection kernel; returns the
    output and whether a kernel ran (the callers count their launches)."""
    if h.ndim != 3 or w.ndim != 2 or w.shape[0] != h.shape[0]:
        raise ValueError(f"{name}: h [H, B, F] and w [H, r], got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: w must be float32")
    _build.require_cuda(name, h, w)
    code = _build.dtype_code(h.dtype)
    H, B, F = h.shape
    r = w.shape[1]
    if H < 1 or H * smem_rows(r) > _MAX_SMEM_FLOATS:
        raise ValueError(f"{name}: H={H} with r={r} needs 1 <= "
                         f"H*{smem_rows(r)} <= {_MAX_SMEM_FLOATS}")
    out = torch.empty((r, B, F), dtype=h.dtype, device=h.device)
    lib = _build.library()
    with _build.device_guard(h.device):
        rc = lib.repro_learned_project(
            h.data_ptr(), w.data_ptr(), out.data_ptr(), H, r, B * F, code,
            _build.stream(h.device))
    _build.check(rc, name)
    return out, out.numel() > 0


def learned_project(h, w):
    """h [H, B, F] (fp32 or bf16, CUDA, contiguous); w [H, r] fp32 ->
    [r, B, F] in h's dtype (fp32 accumulation)."""
    out, ran = launch(h, w, "learned_project")
    if ran:
        launches.add()
    return out
