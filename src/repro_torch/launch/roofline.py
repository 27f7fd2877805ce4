"""Analytic roofline of LM decode: parameter counts, model FLOPs, KV-cache
bytes and the token-level decode service time that calibrates the coded LM
serving simulator (``serving/generation.py:token_service_ms``).

The hardware is a parameter (``Hardware``: peak FLOP/s and memory bytes/s of
one device).  The default, ``H100_SXM``, is NVIDIA's data sheet for the
H100 SXM: 989 TFLOP/s dense bf16 tensor-core rate and 3.35 TB/s HBM3.  The
functions are the JAX package's ``launch/roofline.py`` arithmetic; its
HLO-parsing half (``collective_bytes``, ``analyze``) waits for the dry-run
(``ROADMAP.md`` A9).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    """Peak rates of one device: dense FLOP/s and memory bytes/s."""
    peak_flops: float
    hbm_bw: float


# NVIDIA's H100 SXM data sheet: bf16 dense tensor-core rate, HBM3 rate
H100_SXM = Hardware(peak_flops=989e12, hbm_bw=3.35e12)


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
