"""Model assembly for dense decoder stacks — the JAX package's
``models/transformer.py`` for the plans this port can run.

A model is a stack of ``n_layers`` layers with a repeating superblock of
length ``cfg.period``.  As in the reference, the parameters of the
superblocks are stacked along a leading "group" axis: ``params["blocks"]``
is a tuple with one dict per layer of the period, and every leaf carries a
leading ``n_groups`` axis, so a JAX parameter or cache tree carried over by
``convert.params_from_numpy`` is a tree of this module.  ``jax.lax.scan``
over the groups becomes a Python loop over that axis.

Three entry points per model:
  * ``forward``      — full-sequence teacher-forced logits
  * ``prefill``      — full-sequence + returns per-layer KV caches
  * ``decode_step``  — one token through the cached stack (serving decode;
                       writes the caches in place)

Plans with mamba, MoE, cross-attention or encoder-decoder layers raise
``NotImplementedError``: those modules have no TPU kernel and come in a
later slice (``ROADMAP.md`` A8).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import resolve_device, tree_leaves
from repro_torch.models import layers as L


# --------------------------------------------------------------------------
# Layer plan
# --------------------------------------------------------------------------
def layer_plan(cfg, role="decoder"):
    """Tuple of per-layer specs for one superblock period."""
    plan = []
    for i in range(cfg.period):
        if role == "encoder":
            plan.append({"mixer": "attn", "cross": False, "ffn": "mlp",
                         "causal": False})
            continue
        if cfg.attn_every:                       # hybrid (jamba)
            mixer = "attn" if i == cfg.attn_every // 2 else "mamba"
        elif cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.cross_attn_every and i == cfg.cross_attn_every - 1:
            mixer = "none"                       # VLM cross-attn layer
        else:
            mixer = "attn"
        cross = bool(cfg.cross_attn_every and i == cfg.cross_attn_every - 1)
        if cfg.enc_dec and role == "decoder":
            cross = True
        if cfg.family == "ssm":
            ffn = "none"
        elif cfg.n_experts and (i % cfg.moe_every == cfg.moe_every - 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        plan.append({"mixer": mixer, "cross": cross, "ffn": ffn,
                     "causal": True})
    return tuple(plan)


def _dense_plan(cfg):
    """The layer plan, or NotImplementedError for what the port lacks."""
    plan = layer_plan(cfg)
    bad = sorted({what for spec in plan for what in (
        ("mamba" if spec["mixer"] == "mamba" else None),
        ("moe" if spec["ffn"] == "moe" else None),
        ("cross-attention" if spec["cross"] or spec["mixer"] == "none"
         else None)) if what})
    if cfg.enc_dec:
        bad.append("encoder-decoder")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} layers are not ported yet "
            f"(ROADMAP.md A8); the port runs dense decoder stacks")
    return plan


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_params(cfg, seed=0, *, device="cuda"):
    """Random parameters with the reference's distributions: embedding
    N(0, 0.02^2), dense weights N(0, 1/fan_in), zero biases, unit norm
    scales.  ``seed`` is an int or a ``torch.Generator`` on ``device``
    (the draws differ from JAX's for the same seed; tests carry JAX's
    parameters over with ``convert.params_from_numpy`` instead).
    ``device="meta"`` gives the shapes and dtypes and allocates nothing.
    The leaves do not require grad: a train step turns that on for the
    leaves it trains."""
    dev = resolve_device(device)
    plan = _dense_plan(cfg)
    if dev.type == "meta":
        gen = None                    # a meta tensor holds no draws
    elif isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = L.torch_dtype(cfg)
    D, V, G = cfg.d_model, cfg.vocab, (cfg.n_groups,)
    p = {"embed": (torch.randn((V, D), generator=gen, device=dev)
                   * 0.02).to(dt)}
    p["blocks"] = tuple(
        {"attn": L.init_attention(cfg, gen, device=dev, lead=G),
         "mlp": L.init_mlp(cfg, gen, device=dev, lead=G)} for _ in plan)
    p["final_norm"] = L.make_norm(cfg, D, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((D, V), generator=gen, device=dev)
                        / math.sqrt(D)).to(dt)
    return p


# --------------------------------------------------------------------------
# Layers and stack
# --------------------------------------------------------------------------
def _layer_fwd(cfg, p, x, ctx):
    """Full-sequence dense layer. Returns (x, cache_entry)."""
    cache = {}
    h = L.apply_norm(cfg, p["attn"]["norm"], x)
    o, (k, v) = L.self_attention_fwd(cfg, p["attn"], h, ctx["rope"],
                                     window=ctx["window"])
    x = x + o
    if ctx["collect_cache"]:
        W = ctx["window"]
        if W and k.shape[1] > W:
            k, v = k[:, -W:], v[:, -W:]
        pad = ctx["cache_len"] - k.shape[1]
        if pad > 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cache["attn"] = {"k": k, "v": v}
    h = L.apply_norm(cfg, p["mlp"]["norm"], x)
    return x + L.mlp_fwd(cfg, p["mlp"], h), cache


def _group(tree, g):
    """Group g of a stacked tree (views: writes reach the stacked leaves)."""
    if isinstance(tree, dict):
        return {key: _group(val, g) for key, val in tree.items()}
    return tree[g]


def _stack_fwd(cfg, stacked, x, ctx, plan, remat=False):
    """Python loop over the groups; returns x and, when collecting, the
    caches stacked along a leading group axis as the reference's scan
    stacks them.  ``remat`` checkpoints each group (the reference's
    ``jax.checkpoint`` of the scan body): its activations are recomputed in
    the backward pass instead of kept."""
    def group(x, g):
        caches = []
        for i in range(len(plan)):
            x, c = _layer_fwd(cfg, _group(stacked[i], g), x, ctx)
            caches.append(c)
        return x, caches

    per_group = []
    for g in range(cfg.n_groups):
        if remat:
            x, caches = checkpoint(group, x, g, use_reentrant=False)
        else:
            x, caches = group(x, g)
        per_group.append(caches)
    if not ctx["collect_cache"]:
        return x, None
    return x, tuple(
        {"attn": {name: torch.stack([pg[i]["attn"][name]
                                     for pg in per_group])
                  for name in ("k", "v")}}
        for i in range(len(plan)))


def _stack_decode(cfg, stacked, caches, x, pos, ctx, plan):
    for g in range(cfg.n_groups):
        for i in range(len(plan)):
            p = _group(stacked[i], g)
            h = L.apply_norm(cfg, p["attn"]["norm"], x)
            o, _ = L.self_attention_decode(
                cfg, p["attn"], h, _group(caches[i]["attn"], g), pos,
                ctx["rope"], window=ctx["window"],
                kernel_pos=ctx["kernel_pos"])
            x = x + o
            h = L.apply_norm(cfg, p["mlp"]["norm"], x)
            x = x + L.mlp_fwd(cfg, p["mlp"], h)
    return x


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------
def _embed(cfg, params, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(L.torch_dtype(cfg))
    return embed_tokens(cfg, params, tokens)


def embed_tokens(cfg, params, tokens):
    """Public: token -> embedding (used by the ParM embedding-space
    encoder)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    return params["embed"][tokens.long()]


def _logits(cfg, params, x):
    x = L.apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _rope(cfg, pos):
    """RoPE tables for ``pos``, cast once to the model dtype (the cast
    ``apply_rope`` would make in every layer)."""
    dt = L.torch_dtype(cfg)
    return tuple(t.to(dt) for t in L.rope_tables(
        pos, cfg.resolved_head_dim, cfg.rope_theta))


def _make_ctx(cfg, S, device, *, collect_cache=False, cache_len=0):
    pos = torch.arange(S, device=device)
    return {"rope": _rope(cfg, pos),
            "window": cfg.sliding_window, "collect_cache": collect_cache,
            "cache_len": cache_len}


def forward(cfg, params, tokens=None, embeds=None, remat=False,
            unembed_last_only=False):
    """Teacher-forced full-sequence logits. Returns (logits_f32, aux); aux is
    0 for dense stacks (it carries the MoE router loss in the reference).

    ``remat`` recomputes each group's activations in the backward pass
    (training); ``unembed_last_only`` skips the [B, S, V] unembed and
    projects only the final position — the serving prefill only consumes
    the last token."""
    plan = _dense_plan(cfg)
    x = _embed(cfg, params, tokens, embeds)
    ctx = _make_ctx(cfg, x.shape[1], x.device)
    x, _ = _stack_fwd(cfg, params["blocks"], x, ctx, plan, remat=remat)
    if unembed_last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def prefill(cfg, params, tokens=None, embeds=None, cache_len=0):
    """Process the prompt; returns (last-token logits_f32, cache).

    ``cache_len`` reserves decode slots (>= prompt length, or == window for
    sliding-window archs)."""
    plan = _dense_plan(cfg)
    x = _embed(cfg, params, tokens, embeds)
    S = x.shape[1]
    if not cache_len:
        cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    ctx = _make_ctx(cfg, S, x.device, collect_cache=True,
                    cache_len=cache_len)
    x, caches = _stack_fwd(cfg, params["blocks"], x, ctx, plan)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg, params, cache, pos, token=None, embed=None):
    """One decode step at position ``pos`` (0-based, == #tokens already in
    cache).  ``pos`` may be a python int (whole batch at one position) or a
    [B] vector of per-row positions (tensor or numpy) — the slot-batched
    continuous-decoding path, where each batch row is an independent stream.
    Writes the new key/value rows into ``cache`` in place and returns
    (logits_f32 [B,1,V], cache).

    ``pos`` is converted once per step, not once per layer: a python int
    (scalar) or an int64 device tensor (vector) for RoPE and the slot
    writes, and, on the "kernels" backend, one [B] int32 device tensor that
    every layer's decode-attention kernel reads as it is."""
    plan = _dense_plan(cfg)
    x = _embed(cfg, params, token, embed)
    B = x.shape[0]
    kernels = cfg.attn_backend == "kernels"
    if isinstance(pos, int) or (hasattr(pos, "ndim") and pos.ndim == 0):
        pos = int(pos)
        rope = _rope(cfg, torch.full((1,), pos, device=x.device))
        kernel_pos = torch.full((B,), pos, dtype=torch.int32,
                                device=x.device) if kernels else None
    else:
        given = torch.as_tensor(pos, device=x.device)
        pos = given.long()
        rope = _rope(cfg, pos)
        kernel_pos = given.to(torch.int32) if kernels else None
    ctx = {"rope": rope, "window": cfg.sliding_window,
           "kernel_pos": kernel_pos}
    x = _stack_decode(cfg, params["blocks"], cache, x, pos, ctx, plan)
    return _logits(cfg, params, x), cache


def init_cache(cfg, batch, cache_len, *, device="cuda"):
    """Zero caches: a tuple with one {"attn": {"k", "v"}} per layer of the
    period, leaves [n_groups, batch, S, KV, hd]."""
    dev = resolve_device(device)
    plan = _dense_plan(cfg)
    return tuple({"attn": L.init_attn_cache(cfg, batch, cache_len,
                                            device=dev,
                                            lead=(cfg.n_groups,))}
                 for _ in plan)


def param_count(params):
    return sum(x.numel() for x in tree_leaves(params))
