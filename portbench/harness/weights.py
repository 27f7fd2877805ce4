"""Random weights drawn on the device from ``--seed``, in the port's
parameter layout (``repro_torch.models.transformer``: per-layer leaves
stacked along a leading group axis, dense weights [in, out]) and in the
dtype they are served in.  One draw per leaf, so set-up makes a few large
calls.  The same tensors are handed to the program and to the reference.

The distributions are the port's: the embedding N(0, 0.02^2), every dense
and expert weight N(0, 1/fan_in), norm scales one, the MoE router rounded
through the model dtype and kept in fp32."""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(
        int(seed) % (2 ** 64))


def _normal(gen, shape, std, dtype, device):
    out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return out.mul_(std)


def _dense(gen, lead, fan_in, fan_out, dtype, device):
    return _normal(gen, lead + (fan_in, fan_out), 1 / math.sqrt(fan_in),
                   dtype, device)


def _ones(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def draw(cfg, seed, device):
    """The parameter tree of the decoder-only configuration ``cfg`` (a dict
    of the configuration file's keys), drawn from ``seed`` on ``device``."""
    dt = DTYPES[cfg["dtype"]]
    gen = generator(seed, device)
    D, V = cfg["d_model"], cfg["vocab"]
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    G = (cfg["n_layers"],)
    attn = {"wq": _dense(gen, G, D, H * hd, dt, device),
            "wk": _dense(gen, G, D, KV * hd, dt, device),
            "wv": _dense(gen, G, D, KV * hd, dt, device),
            "wo": _dense(gen, G, H * hd, D, dt, device),
            "norm": {"scale": _ones(G + (D,), dt, device)}}
    if cfg.get("qkv_bias"):
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            attn[name] = torch.zeros(G + (n,), dtype=dt, device=device)
    if cfg.get("qk_norm"):
        attn["q_norm"] = _ones(G + (hd,), dt, device)
        attn["k_norm"] = _ones(G + (hd,), dt, device)
    layer = {"attn": attn}
    if cfg.get("n_experts"):
        E, Fm = cfg["n_experts"], cfg["moe_d_ff"]
        moe = {"router": _dense(gen, G, D, E, dt, device).float(),
               "w1": _normal(gen, G + (E, D, Fm), 1 / math.sqrt(D), dt,
                             device),
               "w3": _normal(gen, G + (E, D, Fm), 1 / math.sqrt(D), dt,
                             device),
               "w2": _normal(gen, G + (E, Fm, D), 1 / math.sqrt(Fm), dt,
                             device),
               "norm": {"scale": _ones(G + (D,), dt, device)}}
        if cfg.get("n_shared_experts"):
            SF = cfg["n_shared_experts"] * Fm
            moe["shared"] = {"w1": _dense(gen, G, D, SF, dt, device),
                             "w3": _dense(gen, G, D, SF, dt, device),
                             "w2": _dense(gen, G, SF, D, dt, device)}
        layer["moe"] = moe
    else:
        F = cfg["d_ff"]
        layer["mlp"] = {"w1": _dense(gen, G, D, F, dt, device),
                        "w2": _dense(gen, G, F, D, dt, device),
                        "w3": _dense(gen, G, D, F, dt, device),
                        "norm": {"scale": _ones(G + (D,), dt, device)}}
    params = {"embed": _normal(gen, (V, D), 0.02, dt, device),
              "blocks": (layer,),
              "final_norm": {"scale": _ones((D,), dt, device)}}
    if not cfg.get("tie_embeddings"):
        params["lm_head"] = _dense(gen, (), D, V, dt, device)
    return params
