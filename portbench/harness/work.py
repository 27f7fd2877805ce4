"""Work counts from shapes, and the table of peaks they are held to.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity): 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in fp32 outside them, 3.35 TB/s of
HBM3.  A kernel's least time is the larger of its operations over the peak
rate of its dtype and its bytes over the memory rate, each input byte read
once and each output byte written once.

``param_count`` / ``active_params`` / ``kv_cache_bytes`` /
``decode_token_cost`` are copied from ``repro_torch.launch.roofline``
(the analytic half), restricted to the decoder-only plans the cells run,
so that the yardstick does not move with the program."""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def head_dim(cfg):
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def least_s(flops, nbytes, dtype):
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S)


# ---------------------------------------------------------------- B7 / B8
def causal_pairs(S, window=0):
    """(query, key) pairs a causal prefill of S positions keeps."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def b7_work(B, Sq, Sk, H, KV, hd, itemsize, window=0):
    """(operations, bytes) of one causal prefill attention call: 4 hd per
    kept (query, key) pair and query head; q, k, v read once, out
    written once."""
    assert Sq == Sk, "the prefill kernel runs query row i at position i"
    flops = 4 * hd * H * B * causal_pairs(Sq, window)
    nbytes = itemsize * hd * B * (2 * Sq * H + 2 * Sk * KV)
    return flops, nbytes


def b8_work(pos, S, H, KV, hd, itemsize):
    """(operations, bytes) of one decode attention call over batch rows at
    positions ``pos``: only the rows j <= pos[b] each row admits, K and V
    each read once; q read and out written once; pos read once."""
    rows = sum(min(int(p) + 1, S) for p in pos)
    B = len(pos)
    flops = 4 * hd * H * rows
    nbytes = itemsize * (2 * rows * KV * hd + 2 * B * H * hd) + 4 * B
    return flops, nbytes


# ------------------------------------------------------- model arithmetic
def layer_params(cfg):
    """Parameters of one layer's matrix products a token goes through:
    attention projections, then the dense MLP, or the router, the top-k
    routed experts and the shared experts."""
    D, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = head_dim(cfg)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.get("n_experts"):
        expert = 3 * D * cfg["moe_d_ff"]
        ffn = D * cfg["n_experts"] + (cfg["moe_top_k"]
                                      + cfg.get("n_shared_experts", 0)) \
            * expert
    else:
        ffn = 3 * D * cfg["d_ff"]
    return attn + ffn


def param_count(cfg):
    """All parameters (every expert; embedding and output head)."""
    D, V = cfg["d_model"], cfg["vocab"]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.get("n_experts"):
        ffn = (cfg["n_experts"] + cfg.get("n_shared_experts", 0)) * 3 * D \
            * cfg["moe_d_ff"] + D * cfg["n_experts"]
    else:
        ffn = 3 * D * cfg["d_ff"]
    head = 0 if cfg.get("tie_embeddings") else D * V
    return V * D + head + cfg["n_layers"] * (attn + ffn)


def active_params(cfg):
    """Parameters a token's logits need: every layer's products
    (``layer_params``) and the output head, without the embedding
    lookup."""
    return cfg["n_layers"] * layer_params(cfg) + cfg["d_model"] * cfg["vocab"]


def attn_flops(cfg, pairs):
    return 4 * head_dim(cfg) * cfg["n_heads"] * cfg["n_layers"] * pairs


def prefill_flops(cfg, P):
    """A prompt of P tokens: every layer for each token, the output head
    for the last, causal attention over the prompt."""
    body = 2 * cfg["n_layers"] * layer_params(cfg)
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return P * body + head + attn_flops(cfg, causal_pairs(P))


def decode_flops(cfg, keys):
    """One decoded token that attends ``keys`` cached positions (itself
    included)."""
    return 2 * active_params(cfg) + attn_flops(cfg, keys)


def kv_cache_bytes(cfg, kv_len, batch=1):
    return cfg["n_layers"] * 2 * kv_len * cfg["n_kv_heads"] * head_dim(cfg) \
        * ITEMSIZE[cfg["dtype"]] * batch


def decode_token_cost(cfg, *, batch=1, kv_len=0):
    """Seconds per decode step of ``batch`` streams at ``kv_len`` cached
    positions at the chip's peaks: every active parameter and cached K/V
    byte read once, or the products at the peak rate, whichever is
    longer."""
    active = param_count(cfg) - (
        cfg["n_layers"] * (cfg["n_experts"] - cfg["moe_top_k"]) * 3
        * cfg["d_model"] * cfg["moe_d_ff"] if cfg.get("n_experts") else 0)
    mem = (active * ITEMSIZE[cfg["dtype"]]
           + kv_cache_bytes(cfg, kv_len, batch)) / HBM_BYTES_S
    comp = 2 * active * batch / PEAK_FLOPS[cfg["dtype"]]
    return max(mem, comp)
