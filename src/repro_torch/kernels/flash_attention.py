"""CUDA kernel wrapper: prefill attention (causal / sliding-window GQA with
an fp32 online softmax),

    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // rep] / sqrt(hd))
                   v[b, j, h // rep]

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (a Pallas TPU
kernel).  Each block owns a (b, h, query tile) and sweeps the key tiles
itself, so m / l / acc stay in registers instead of a sequential grid axis's
scratch.  The route follows the dtype, and nothing falls back from one to
the other:

- bf16: ``csrc/attention_kernels.cu:flash_wgmma_kernel``, both products on
  the tensor cores (``wgmma``) with K / V tiles copied by TMA into a
  two-stage mbarrier ring; P is rounded to bf16 before P.V;
- fp32: ``flash_kernel``, SIMT fp32, which holds the fp32 tolerance (2e-5)
  that bf16 tensor-core inputs cannot.

A failed build, tensor-map encode or launch raises.  Like the TPU kernel it
has no ``q_offset`` (query row i sits at position i) and no backward pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("flash_attention")
# launches by route (the dtype picks it); they sum to ``launches``
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
route_launches = {name: _build.LaunchCounter(f"flash_attention.{name}")
                  for name in ROUTES.values()}

HEAD_DIMS = (32, 64, 128)


def flash_attention(q, k, v, *, causal=True, window=0, checked=False):
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd] (fp32 or bf16, one dtype, CUDA,
    contiguous), hd in (32, 64, 128), H a multiple of KV -> [B,Sq,H,hd] in
    q's dtype.  ``checked`` launches from the bounds-checked build and
    counts nothing."""
    name = "flash_attention"
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q [B,Sq,H,hd] and k, v [B,Sk,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or KV < 1 or H % KV:
        raise ValueError(f"{name}: needs hd in {HEAD_DIMS} and H a multiple "
                         f"of KV, got hd={hd} H={H} KV={KV}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype")
    _build.require_cuda(name, q, k, v)
    _build.require_aligned(name, q, k, v)
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library(checked)
    with _build.device_guard(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, int(bool(causal)), int(window), hd ** -0.5, code,
            _build.stream(q.device))
    _build.check(rc, name)
    if not checked:
        launches.add()
        route_launches[ROUTES[q.dtype]].add()
    return out
