"""CUDA kernel wrapper: fused parity encode -> first forward matmul.

    out[j, b, v] = sum_f ( sum_i C[j, i] * X[i, b, f] ) * W[j, f, v]

Replaces ``repro/kernels/fused_encode_forward.py:fused_encode_forward`` (a
Pallas TPU kernel) with ``csrc/parity_kernels.cu:fused_cluster_kernel``, one
launch: a SIMT fp32 GEMM in which a producer warp brings both operands by TMA
into a ring and encodes each stage once in shared memory (the [r, B, F]
encoded queries never reach device memory) while four warps run the FMAs,
with F split over the CTAs of a thread-block cluster whose partial tiles sum
through distributed shared memory.

The launch plan is here, in Python, as the kernel computes it
(``fused_plan``: the cluster size S, the largest whose clusters all fit on
the card at once, and the grid; ``fused_slices``: the F range of each CTA
rank); ``card_plan`` reads the card's own."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("fused_encode_forward")

BM, BN, BK = 64, 64, 32   # kFBM, kFBN, kFBK: output tile, stage depth
WARPS = 8                 # kFThreads / 32: four FMA warps, four producers
MAX_CLUSTER = 8           # kFMaxCluster (portable)
MAX_K = 8                 # kFMaxK: query tiles the ring holds
_MAX_B = 65535 * BM       # gridDim.y limit times the batch tile


def fused_slices(F, S):
    """[begin, end) of F for each CTA rank of a cluster of S: rank s takes
    steps [s * n // S, (s + 1) * n // S) of the n = ceil(F / BK) steps of
    depth BK (``parity_kernels.cu:fused_cluster_kernel``); a rank may be
    empty where F has fewer steps than S."""
    n = math.ceil(F / BK)
    return [(min(s * n // S * BK, F), min((s + 1) * n // S * BK, F))
            for s in range(S)]


def fused_plan(k, r, B, F, V, clusters):
    """(BM, BN, S, grid) of the launch for queries [k, B, F] and weights
    [r, F, V], given ``clusters`` {S: clusters of S CTAs the card holds at
    once} for this k (``parity_kernels.cu:fused_cluster_size``): S is the
    largest cluster size whose r * ceil(B / BM) * ceil(V / BN) clusters all
    fit in one wave, else 1.  The grid is (S times the V tiles, the B tiles,
    r), clusters of S along x."""
    del k, F                   # they enter through ``clusters`` and slices
    tiles = r * math.ceil(B / BM) * math.ceil(V / BN)
    S = max([s for s in range(2, MAX_CLUSTER + 1)
             if clusters.get(s, 0) >= tiles], default=1)
    return BM, BN, S, (S * math.ceil(V / BN), math.ceil(B / BM), r)


def _tma(queries, weights):
    """Whether the kernel loads by TMA (every row 16-byte aligned, F > 0),
    as ``parity_kernels.cu:launch_fused`` decides (the output, fresh from
    the allocator, is aligned)."""
    F, V = queries.shape[2], weights.shape[2]
    return F > 0 and F * queries.element_size() % 16 == 0 and \
        V * weights.element_size() % 16 == 0 and \
        (queries.data_ptr() | weights.data_ptr()) % 16 == 0


def card_plan(queries, weights):
    """(S, {S: clusters}) the kernel launches with on these CUDA inputs:
    the card's cluster capacities for their instance and k
    (``repro_fused_plan``), and the cluster size its rule picks."""
    k, B, _ = queries.shape
    r, _, V = weights.shape
    cap = (ctypes.c_int * (MAX_CLUSTER + 1))()
    size = ctypes.c_int(0)
    with _build.device_guard(queries.device):
        rc = _build.library().repro_fused_plan(
            k, r, B, V, _build.dtype_code(queries.dtype),
            _build.dtype_code(weights.dtype),
            int(_tma(queries, weights)), cap, ctypes.byref(size))
    _build.check(rc, "fused_encode_forward plan")
    return size.value, {s: cap[s] for s in range(1, MAX_CLUSTER + 1)}


def _check(queries, coeffs, weights):
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
    if not 1 <= queries.shape[0] <= MAX_K:
        raise ValueError(f"fused_encode_forward: k={queries.shape[0]} not in "
                         f"1..{MAX_K}")
    if queries.shape[1] > _MAX_B:
        raise ValueError(f"fused_encode_forward: B={queries.shape[1]} "
                         f"exceeds {_MAX_B}")


def launch(queries, coeffs, weights, checked=False):
    """One launch of the kernel from ``_build.library(checked)`` (the
    bounds-checked build where ``checked``); counts nothing."""
    _check(queries, coeffs, weights)
    cx = _build.dtype_code(queries.dtype)
    cw = _build.dtype_code(weights.dtype)
    k, B, F = queries.shape
    r, _, V = weights.shape
    out = torch.empty((r, B, V), dtype=queries.dtype, device=queries.device)
    lib = _build.library(checked)
    with _build.device_guard(queries.device):
        rc = lib.repro_fused_encode_forward(
            queries.data_ptr(), coeffs.data_ptr(), weights.data_ptr(),
            out.data_ptr(), k, r, B, F, V, cx, cw,
            _build.stream(queries.device))
    _build.check(rc, "fused_encode_forward")
    return out


def fused_encode_forward(queries, coeffs, weights):
    """queries [k, B, F], 1 <= k <= 8; coeffs [r, k] fp32; weights
    [r, F, V] (fp32 or bf16 each, CUDA, contiguous) -> [r, B, V] in the
    queries' dtype."""
    out = launch(queries, coeffs, weights)
    if out.numel():
        launches.add()
    return out
