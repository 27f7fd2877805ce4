"""CUDA kernel wrapper: one-token GQA decode attention over a KV cache, per
batch row at its own position,

    out[b, h] = softmax_{j <= pos[b]}(q[b, h] . kc[b, j, g] / sqrt(hd))
                vc[b, j, g]                              g = h // rep

Replaces ``repro/kernels/decode_attention.py:decode_attention`` (a Pallas
TPU kernel) with ``csrc/attention_kernels.cu:decode_kernel``: the rep query
heads of a KV head share one read of the cache, and the slot sweep is split
over blocks (flash-decoding) so a small batch still spreads over the SMs,
with ``decode_combine_kernel`` as the second pass when there is more than
one split."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("decode_attention")

HEAD_DIMS = (32, 64, 128)
MAX_REP = 16              # kMaxRep: query heads per KV head
TILE = 64                 # kDecTile: slots per tile
TARGET_BLOCKS = 264       # two blocks per SM of the H100's 132


def split_plan(B, S, KV):
    """(n_split, chunk): chunks of whole tiles, enough of them that the grid
    (n_split, KV, B) has about TARGET_BLOCKS blocks, and no more splits than
    tiles."""
    n_tiles = max(1, math.ceil(S / TILE))
    n_split = max(1, min(n_tiles, math.ceil(TARGET_BLOCKS / (B * KV))))
    chunk = math.ceil(n_tiles / n_split) * TILE
    return math.ceil(S / chunk), chunk


def decode_attention(q, k_cache, v_cache, pos):
    """q [B,H,hd]; caches [B,S,KV,hd] (fp32 or bf16, one dtype, CUDA,
    contiguous), hd in (32, 64, 128), H / KV <= 16; pos an int32 CUDA tensor,
    [] or [B] -> [B,H,hd] in q's dtype.  Valid slots: j <= pos[b]."""
    name = "decode_attention"
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape \
            or q.shape[0] != k_cache.shape[0] or q.shape[2] != k_cache.shape[3]:
        raise ValueError(f"{name}: q [B,H,hd] and caches [B,S,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if hd not in HEAD_DIMS or KV < 1 or H % KV or H // KV > MAX_REP:
        raise ValueError(f"{name}: needs hd in {HEAD_DIMS} and H a multiple "
                         f"of KV with H/KV <= {MAX_REP}, got hd={hd} H={H} "
                         f"KV={KV}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError(f"{name}: q and the caches must share a dtype")
    if not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32 or \
            pos.shape not in ((), (B,)):
        raise TypeError(f"{name}: pos must be an int32 tensor of shape [] "
                        f"or [{B}]")
    pos = pos.expand(B).contiguous()
    _build.require_cuda(name, q, k_cache, v_cache, pos)
    _build.require_aligned(name, q, k_cache, v_cache)
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_split, chunk = split_plan(B, S, KV)
    rep = H // KV
    if n_split > 1:
        part_ml = torch.empty((B, KV, n_split, rep, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B, KV, n_split, rep, hd),
                               dtype=torch.float32, device=q.device)
        ptrs = part_ml.data_ptr(), part_acc.data_ptr()
    else:
        ptrs = None, None
    lib = _build.library()
    with _build.device_guard(q.device):
        rc = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), *ptrs, B, S, H, KV, hd, n_split,
            chunk, hd ** -0.5, code, _build.stream(q.device))
    _build.check(rc, name)
    launches.add()
    return out
