"""CUDA kernel wrapper: prefill attention (causal / sliding-window GQA with
an fp32 online softmax),

    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // rep] / sqrt(hd))
                   v[b, j, h // rep]

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (a Pallas TPU
kernel) with ``csrc/attention_kernels.cu:flash_kernel``: one block per
(b, h, 32-row query tile) sweeping the key tiles itself, so m / l / acc stay
in registers instead of a sequential grid axis's scratch.  Like the TPU
kernel it has no ``q_offset`` (query row i sits at position i) and no
backward pass."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("flash_attention")

HEAD_DIMS = (32, 64, 128)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd] (fp32 or bf16, one dtype, CUDA,
    contiguous), hd in (32, 64, 128), H a multiple of KV -> [B,Sq,H,hd] in
    q's dtype."""
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
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, int(bool(causal)), int(window), hd ** -0.5, code,
            _build.stream(q.device))
    _build.check(rc, name)
    launches.add()
    return out
