"""Roofline of the launch steps: the analytic half (parameter counts, model
FLOPs, KV-cache bytes and the token-level decode service time that calibrates
the coded LM serving simulator, ``serving/generation.py:token_service_ms``)
and the traced half (``Trace``, ``collective_bytes``, ``Roofline``,
``analyze``) that the dry run reads.

The hardware is a parameter (``Hardware``: peak FLOP/s, memory bytes/s and
link bytes/s of one device).  The default, ``H100_SXM``, is NVIDIA's data
sheet for the H100 SXM: 989 TFLOP/s dense bf16 tensor-core rate, 3.35 TB/s
HBM3, and 450 GB/s of NVLink per direction (the sheet's 900 GB/s is both
directions together).

Where the reference reads XLA's compiled program (``cost_analysis`` and the
collectives in its HLO text, per device after SPMD partitioning), PyTorch
has no HLO: ``Trace`` is a ``TorchDispatchMode`` that sees the ops below
DTensor, on each rank's local shards, during one eager step, and records

* each aten op's FLOPs, counted as ``torch.utils.flop_counter`` counts them;
* each op's input and output bytes (views and allocations move none);
* each ``_c10d_functional`` collective's result shapes and dtypes.

So the terms are per device, as the reference's are, with two differences:
bytes are counted per unfused op (an elementwise chain XLA fuses is read
and written once per op here), so the memory term is an upper bound; and a
Python loop over layers or key blocks is traced trip by trip, so nothing is
counted once per loop (the reference's scan correction is not needed).  On a
CPU mesh DTensor turns an all-to-all into an all-gather and a chunk, and
records it so.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class Hardware:
    """Peak rates of one device: dense FLOP/s, memory bytes/s and the
    bytes/s of its link to the other devices."""
    peak_flops: float
    hbm_bw: float
    link_bw: float = 450e9
    name: str = "NVIDIA H100 SXM (data sheet)"


# NVIDIA's H100 SXM data sheet: bf16 dense tensor-core rate, HBM3 rate,
# NVLink 900 GB/s over both directions
H100_SXM = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# _c10d_functional op -> the reference's HLO collective kind (PyTorch's
# functional collectives have no collective-permute)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class Collective:
    """One collective: its kind and its result shapes and dtypes."""
    kind: str
    results: list


def _nbytes(shape, dtype):
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def collective_bytes(records):
    """Sum per-device result bytes of collectives, bucketed by kind."""
    out = {c: 0 for c in _COLLECTIVES}
    count = {c: 0 for c in _COLLECTIVES}
    for rec in records:
        out[rec.kind] += sum(_nbytes(s, dt) for s, dt in rec.results)
        count[rec.kind] += 1
    return out, count


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


class Trace:
    """Records one step's local ops and collectives (see the module's
    docstring); use as a context manager.  ``flops`` and ``bytes`` are the
    totals, ``collectives`` the ``Collective`` records."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = []
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        trace = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return trace._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None

    def _dispatch(self, func, types, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented         # let DTensor run its local ops
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                    # DTensor's shape propagation
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in _KINDS:
                self.collectives.append(Collective(
                    _KINDS[name], [(tuple(t.shape), t.dtype) for t in outs]))
            return out
        if func.is_view or name.startswith("empty"):
            return out
        self.ops += 1
        flop_fn = flop_registry.get(func.overloadpacket)
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        self.bytes += sum(t.numel() * t.dtype.itemsize
                          for t in _tensors(args) + _tensors(kwargs) + outs)
        return out


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_detail: dict
    coll_counts: dict
    chips: int
    hw: Hardware = field(default=H100_SXM)

    @property
    def compute_s(self):
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_s(self):
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self):
        return self.coll_bytes_per_device / self.hw.link_bw

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self):
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_detail": self.coll_detail,
            "coll_counts": self.coll_counts,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hardware": {"name": self.hw.name,
                         "peak_flops": self.hw.peak_flops,
                         "hbm_bw": self.hw.hbm_bw,
                         "link_bw": self.hw.link_bw},
        }


def analyze(trace, chips, hw=H100_SXM):
    """Roofline of one traced step (a ``Trace``) on ``chips`` devices."""
    detail, counts = collective_bytes(trace.collectives)
    coll = float(sum(detail.values()))
    return Roofline(float(trace.flops), float(trace.bytes), coll, detail,
                    counts, chips, hw)


def model_flops(cfg, n_tokens, n_params=None, active_params=None):
    """MODEL_FLOPS = 6 * N * D (dense) or 6 * N_active * D (MoE)."""
    n = active_params if active_params is not None else n_params
    return 6.0 * n * n_tokens


def active_param_count(cfg, n_params):
    """Approximate active params for MoE: replace full expert banks with the
    top-k (+shared) slice."""
    if not cfg.n_experts:
        return n_params
    expert_p = 3 * cfg.d_model * cfg.moe_d_ff       # w1,w2,w3 per expert
    n_moe_layers = cfg.n_layers // cfg.moe_every
    total_experts = n_moe_layers * cfg.n_experts * expert_p
    active_experts = n_moe_layers * cfg.moe_top_k * expert_p
    return n_params - total_experts + active_experts


def _layer_counts(cfg):
    """(n_attn_layers, n_mamba_layers) from the superblock plan."""
    if cfg.attn_every:                  # hybrid: one attn layer per period
        n_periods = cfg.n_layers // cfg.period
        return n_periods, cfg.n_layers - n_periods
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    return cfg.n_layers, 0


def estimate_param_count(cfg):
    """Parameter count from config arithmetic alone — no init."""
    D, V = cfg.d_model, cfg.vocab
    n_attn, n_mamba = _layer_counts(cfg)
    p = V * D                                        # embedding
    if not cfg.tie_embeddings:
        p += D * V                                   # lm_head
    if n_attn and cfg.n_heads:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        p += n_attn * (D * H * hd + 2 * D * KV * hd + H * hd * D)
    if n_mamba:
        d_inner = cfg.ssm_expand * D
        # in/out projections dominate; conv/dt/A/D terms are noise at scale
        p += n_mamba * 3 * D * d_inner
    # ffn: moe layers carry n_experts (+shared) expert MLPs + router,
    # the rest carry a dense (SwiGLU) MLP
    n_ffn = cfg.n_layers if not (cfg.family == "ssm" and not cfg.attn_every) \
        else 0
    if cfg.n_experts:
        n_moe = cfg.n_layers // cfg.moe_every
        expert_p = 3 * D * cfg.moe_d_ff
        p += n_moe * (cfg.n_experts + cfg.n_shared_experts) * expert_p
        p += n_moe * D * cfg.n_experts               # router
        n_dense = n_ffn - n_moe
    else:
        n_dense = n_ffn
    if cfg.d_ff:
        p += n_dense * 3 * D * cfg.d_ff
    return p


def kv_cache_bytes(cfg, kv_len, batch=1):
    """Decode-step KV traffic: every cached K/V byte is read once per token."""
    n_attn, _ = _layer_counts(cfg)
    S = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len
    bytes_per = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    cache = 0
    if n_attn and cfg.n_heads:
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        cache = n_attn * 2 * S * KV * hd * bytes_per * batch
    if cfg.ssm_state:
        _, n_mamba = _layer_counts(cfg)
        d_inner = cfg.ssm_expand * cfg.d_model
        n_heads_ssm = max(1, d_inner // cfg.ssm_head_dim)
        cache += n_mamba * n_heads_ssm * cfg.ssm_state * cfg.ssm_head_dim \
            * 4 * batch                              # fp32 SSM state
    return cache


def decode_token_cost(cfg, *, n_params=None, batch=1, kv_len=0, tp=1,
                      hw=H100_SXM):
    """Seconds per decode step (one token per active stream) on ``hw``.

    Autoregressive decode at small batch is memory-bound: every active
    parameter and every cached KV byte streams from device memory once per
    step, so

        t = (active_param_bytes / tp + kv_bytes / tp) / hw.hbm_bw

    with a compute-term floor for large batch.  ``tp`` is the tensor-
    parallel degree."""
    if n_params is None:
        n_params = estimate_param_count(cfg)
    active = active_param_count(cfg, n_params)
    bytes_per = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    mem_s = (active * bytes_per / tp
             + kv_cache_bytes(cfg, kv_len, batch) / tp) / hw.hbm_bw
    comp_s = model_flops(cfg, batch, active_params=active) / (
        tp * hw.peak_flops)
    return max(mem_s, comp_s)
