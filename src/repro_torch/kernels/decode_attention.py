"""CUDA kernel wrapper: one-token GQA decode attention over a KV cache, per
batch row at its own position,

    out[b, h] = softmax_{j <= pos[b]}(q[b, h] . kc[b, j, g] / sqrt(hd))
                vc[b, j, g]                              g = h // rep

Replaces ``repro/kernels/decode_attention.py:decode_attention`` (a Pallas
TPU kernel) with ``csrc/attention_kernels.cu:decode_cluster_kernel``, one
launch: the rep query heads of a KV head share one read of the cache, the
slot sweep of each (b, kv-head) is split over the CTAs of a thread-block
cluster, and the splits combine through distributed shared memory inside
the launch.  The route follows the dtype and nothing falls back: bf16 runs
both products on the tensor cores (``mma.sync``, P rounded to bf16 before
P.V), fp32 in SIMT (it holds the fp32 tolerance, 2e-5).

The launch plan is here, in Python: the cluster size (16 CTAs where the card
holds as many CTAs in clusters of 16 as in clusters of 8, else 8, decided
once per kernel instance at first use) and the slots each CTA takes
(``cta_slots``, the kernel's arithmetic on the device's ``pos``)."""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter("decode_attention")
# launches by route (the dtype picks it); they sum to ``launches``
ROUTES = {torch.bfloat16: "mma", torch.float32: "simt"}
route_launches = {name: _build.LaunchCounter(f"decode_attention.{name}")
                  for name in ROUTES.values()}

HEAD_DIMS = (32, 64, 128)
MAX_REP = 16              # kMaxRep: query heads per KV head (the mma's M)
CHUNK = 16                # kDecChunk: slots per warp step (the mma's K)
CLUSTER_SIZES = (16, 8)   # kMaxCluster (non-portable), then the portable 8

_clusters = {}            # (dtype, hd) -> (cluster size, {size: capacity})
_clusters_lock = threading.Lock()


def cta_slots(n_valid, cluster):
    """[begin, end) slots of each CTA rank of one (b, kv-head) cluster for
    ``n_valid`` valid slots: ceil(n_valid / cluster) rounded up to a multiple
    of CHUNK each, the last CTAs empty where the rounding leaves them none
    (``attention_kernels.cu:cta_range``)."""
    share = math.ceil(math.ceil(n_valid / cluster) / CHUNK) * CHUNK
    return [(min(r * share, n_valid), min(r * share + share, n_valid))
            for r in range(cluster)]


def cluster_plan(B, KV, cluster):
    """The launch grid (cluster, KV, B): one cluster of ``cluster`` CTAs per
    (b, kv-head) along x."""
    if not 1 <= cluster <= max(CLUSTER_SIZES):
        raise ValueError(f"decode_attention: cluster size {cluster} not in "
                         f"1..{max(CLUSTER_SIZES)}")
    return cluster, KV, B


def choose_cluster(capacity):
    """16 where the card keeps at least as many CTAs resident in clusters
    of 16 as in clusters of 8 (``capacity``: clusters of each size it holds
    at once), else 8; raises when it holds no cluster of 8."""
    big, small = CLUSTER_SIZES
    if capacity.get(small, 0) < 1:
        raise RuntimeError(f"decode_attention: the card holds no cluster of "
                           f"{small} CTAs of the decode kernel ({capacity})")
    if capacity.get(big, 0) * big >= capacity[small] * small:
        return big
    return small


def cluster_size(dtype, hd):
    """The cluster size of the (dtype, hd) kernel instance on the current
    card, decided at its first use from cudaOccupancyMaxActiveClusters."""
    key = (dtype, hd)
    if key not in _clusters:
        with _clusters_lock:
            if key not in _clusters:
                lib = _build.library()
                capacity = {}
                for size in CLUSTER_SIZES:
                    n = ctypes.c_int(0)
                    rc = lib.repro_decode_cluster_capacity(
                        hd, _build.dtype_code(dtype), size, ctypes.byref(n))
                    capacity[size] = n.value if rc == 0 else 0
                _clusters[key] = (choose_cluster(capacity), capacity)
    return _clusters[key][0]


def cluster_decisions():
    """{(dtype, hd): (cluster size, {size: clusters the card holds})} for
    every instance decided so far."""
    return dict(_clusters)


def decode_attention(q, k_cache, v_cache, pos, checked=False):
    """q [B,H,hd]; caches [B,S,KV,hd] (fp32 or bf16, one dtype, CUDA,
    contiguous), hd in (32, 64, 128), H / KV <= 16; pos an int32 CUDA tensor,
    [] or [B] -> [B,H,hd] in q's dtype.  Valid slots: j <= pos[b].
    ``checked`` launches from the bounds-checked build (clusters of the size
    decided for the unchecked one) and counts nothing."""
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
    lib = _build.library(checked)
    with _build.device_guard(q.device):
        grid = cluster_plan(B, KV, cluster_size(q.dtype, hd))
        rc = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, S, H, KV, hd, grid[0],
            hd ** -0.5, code, _build.stream(q.device))
    _build.check(rc, name)
    if not checked:
        launches.add()
        route_launches[ROUTES[q.dtype]].add()
    return out
