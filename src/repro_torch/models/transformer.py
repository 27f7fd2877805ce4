"""Model assembly for decoder-only stacks — the JAX package's
``models/transformer.py`` for every plan without cross attention: dense,
MoE, SSM (Mamba2) and hybrid (Jamba) stacks.

A model is a stack of ``n_layers`` layers with a repeating superblock of
length ``cfg.period``.  As in the reference, the parameters of the
superblocks are stacked along a leading "group" axis: ``params["blocks"]``
is a tuple with one dict per layer of the period, and every leaf carries a
leading ``n_groups`` axis, so a JAX parameter or cache tree carried over by
``convert.params_from_numpy`` is a tree of this module.  ``jax.lax.scan``
over the groups becomes a Python loop over that axis.

Each layer of the period is a spec of ``layer_plan``: a mixer (``attn`` or
``mamba``) and an FFN (``mlp``, ``moe`` or none), with the reference's
per-spec parameter keys.

Three entry points per model:
  * ``forward``      — full-sequence teacher-forced logits and the MoE
                       router loss summed over layers
  * ``prefill``      — full-sequence + returns per-layer KV / SSM caches
  * ``decode_step``  — one token through the cached stack (serving decode;
                       writes the key/value rows, SSM states and conv tails
                       into the caches in place)

Plans with cross-attention or encoder-decoder layers (llama-3.2-vision,
seamless-m4t) raise ``NotImplementedError``: they come in a later slice
(``ROADMAP.md`` A5).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import resolve_device, tree_leaves
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE


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


def _plan(cfg):
    """The layer plan, or NotImplementedError for what the port lacks."""
    plan = layer_plan(cfg)
    if cfg.enc_dec or any(spec["cross"] or spec["mixer"] == "none"
                          for spec in plan):
        what = "encoder-decoder" if cfg.enc_dec else "cross-attention"
        raise NotImplementedError(
            f"{cfg.name}: {what} layers are not ported yet (ROADMAP.md A5); "
            f"the port runs decoder-only stacks")
    return plan


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_layer(cfg, gen, spec, *, device="cpu", lead=()):
    """One layer of the period: {"attn" | "mamba", "mlp" | "moe"} as the
    spec says (``lead`` prepends the stacked group axis)."""
    kw = dict(device=device, lead=lead)
    p = {}
    if spec["mixer"] == "attn":
        p["attn"] = L.init_attention(cfg, gen, **kw)
    elif spec["mixer"] == "mamba":
        p["mamba"] = M.init_mamba(cfg, gen, **kw)
    if spec["ffn"] == "mlp":
        p["mlp"] = L.init_mlp(cfg, gen, **kw)
    elif spec["ffn"] == "moe":
        p["moe"] = MOE.init_moe(cfg, gen, **kw)
    return p


def init_params(cfg, seed=0, *, device="cuda"):
    """Random parameters with the reference's distributions: embedding
    N(0, 0.02^2), dense weights N(0, 1/fan_in), zero biases, unit norm
    scales, the SSM's A_log, D and dt_bias and the MoE router in fp32.
    ``seed`` is an int or a ``torch.Generator`` on ``device`` (the draws
    differ from JAX's for the same seed; tests carry JAX's parameters over
    with ``convert.params_from_numpy`` instead).  ``device="meta"`` gives
    the shapes and dtypes and allocates nothing.  The leaves do not require
    grad: a train step turns that on for the leaves it trains."""
    dev = resolve_device(device)
    plan = _plan(cfg)
    if dev.type == "meta":
        gen = None                    # a meta tensor holds no draws
    elif isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = L.torch_dtype(cfg)
    D, V = cfg.d_model, cfg.vocab
    p = {"embed": (torch.randn((V, D), generator=gen, device=dev)
                   * 0.02).to(dt)}
    p["blocks"] = tuple(init_layer(cfg, gen, spec, device=dev,
                                   lead=(cfg.n_groups,)) for spec in plan)
    p["final_norm"] = L.make_norm(cfg, D, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((D, V), generator=gen, device=dev)
                        / math.sqrt(D)).to(dt)
    return p


# --------------------------------------------------------------------------
# Layers and stack
# --------------------------------------------------------------------------
def _layer_fwd(cfg, spec, p, x, ctx):
    """Full-sequence layer. Returns (x, aux, cache_entry): aux is the MoE
    router loss (a python 0.0 without MoE, which launches nothing), the
    cache entry {"attn": {"k", "v"}} or {"ssm": {"ssm", "conv"}} when
    ``ctx["collect_cache"]``."""
    aux = 0.0
    cache = {}
    if spec["mixer"] == "attn":
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
    elif spec["mixer"] == "mamba":
        h = L.apply_norm(cfg, p["mamba"]["norm"], x)
        o, state = M.ssd_fwd(cfg, p["mamba"], h,
                             return_state=ctx["collect_cache"])
        x = x + o
        if ctx["collect_cache"]:
            cache["ssm"] = state
    if spec["ffn"] == "mlp":
        h = L.apply_norm(cfg, p["mlp"]["norm"], x)
        x = x + L.mlp_fwd(cfg, p["mlp"], h)
    elif spec["ffn"] == "moe":
        h = L.apply_norm(cfg, p["moe"]["norm"], x)
        o, aux = MOE.moe_fwd(cfg, p["moe"], h)
        x = x + o
    return x, aux, cache


def _group(tree, g):
    """Group g of a stacked tree (views: writes reach the stacked leaves)."""
    if isinstance(tree, dict):
        return {key: _group(val, g) for key, val in tree.items()}
    return tree[g]


def _stack(trees):
    """Per-group trees of one layer -> one tree, leaves stacked along a
    leading group axis (the reference's scan output)."""
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def _stack_fwd(cfg, stacked, x, ctx, plan, remat=False):
    """Python loop over the groups; returns x, the aux loss summed over
    layers and groups and, when collecting, the caches stacked along a
    leading group axis as the reference's scan stacks them.  ``remat``
    checkpoints each group (the reference's ``jax.checkpoint`` of the scan
    body): its activations are recomputed in the backward pass instead of
    kept."""
    def group(x, g):
        aux = 0.0
        caches = []
        for i, spec in enumerate(plan):
            x, a, c = _layer_fwd(cfg, spec, _group(stacked[i], g), x, ctx)
            aux = aux + a
            caches.append(c)
        return x, aux, caches

    aux = 0.0
    per_group = []
    for g in range(cfg.n_groups):
        if remat:
            x, a, caches = checkpoint(group, x, g, use_reentrant=False)
        else:
            x, a, caches = group(x, g)
        aux = aux + a
        per_group.append(caches)
    if not ctx["collect_cache"]:
        return x, aux, None
    return x, aux, tuple(_stack([pg[i] for pg in per_group])
                         for i in range(len(plan)))


def _stack_decode(cfg, stacked, caches, x, pos, ctx, plan):
    """One token through every layer; key/value rows, SSM states and conv
    tails are written into ``caches`` in place.  The MoE aux is dropped, as
    in the reference's decode."""
    for g in range(cfg.n_groups):
        for i, spec in enumerate(plan):
            p = _group(stacked[i], g)
            if spec["mixer"] == "attn":
                h = L.apply_norm(cfg, p["attn"]["norm"], x)
                o, _ = L.self_attention_decode(
                    cfg, p["attn"], h, _group(caches[i]["attn"], g), pos,
                    ctx["rope"], window=ctx["window"],
                    kernel_pos=ctx["kernel_pos"])
                x = x + o
            elif spec["mixer"] == "mamba":
                h = L.apply_norm(cfg, p["mamba"]["norm"], x)
                cache = _group(caches[i]["ssm"], g)
                o, new = M.ssd_decode(cfg, p["mamba"], h, cache)
                for name in ("ssm", "conv"):
                    cache[name].copy_(new[name])
                x = x + o
            if spec["ffn"] == "mlp":
                h = L.apply_norm(cfg, p["mlp"]["norm"], x)
                x = x + L.mlp_fwd(cfg, p["mlp"], h)
            elif spec["ffn"] == "moe":
                h = L.apply_norm(cfg, p["moe"]["norm"], x)
                x = x + MOE.moe_fwd(cfg, p["moe"], h)[0]
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
    ``apply_rope`` would make in every layer); (None, None) for an
    attention-free model."""
    if not cfg.n_heads:
        return None, None
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
    the MoE router loss summed over layers and groups (0 without MoE).

    ``remat`` recomputes each group's activations in the backward pass
    (training); ``unembed_last_only`` skips the [B, S, V] unembed and
    projects only the final position — the serving prefill only consumes
    the last token."""
    plan = _plan(cfg)
    x = _embed(cfg, params, tokens, embeds)
    ctx = _make_ctx(cfg, x.shape[1], x.device)
    x, aux, _ = _stack_fwd(cfg, params["blocks"], x, ctx, plan, remat=remat)
    if unembed_last_only:
        x = x[:, -1:]
    if not isinstance(aux, torch.Tensor):          # no MoE layer
        aux = torch.zeros((), device=x.device)
    return _logits(cfg, params, x), aux


def prefill(cfg, params, tokens=None, embeds=None, cache_len=0):
    """Process the prompt; returns (last-token logits_f32, cache).

    ``cache_len`` reserves decode slots (>= prompt length, or == window for
    sliding-window archs)."""
    plan = _plan(cfg)
    x = _embed(cfg, params, tokens, embeds)
    S = x.shape[1]
    if not cache_len:
        cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    ctx = _make_ctx(cfg, S, x.device, collect_cache=True,
                    cache_len=cache_len)
    x, _, caches = _stack_fwd(cfg, params["blocks"], x, ctx, plan)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg, params, cache, pos, token=None, embed=None):
    """One decode step at position ``pos`` (0-based, == #tokens already in
    cache).  ``pos`` may be a python int (whole batch at one position) or a
    [B] vector of per-row positions (tensor or numpy) — the slot-batched
    continuous-decoding path, where each batch row is an independent stream.
    Writes the new key/value rows, SSM states and conv tails into ``cache``
    in place and returns (logits_f32 [B,1,V], cache): a step run twice on
    one cache advances its SSM states twice, so callers that need the old
    cache clone it.

    ``pos`` is converted once per step, not once per layer: a python int
    (scalar) or an int64 device tensor (vector) for RoPE and the slot
    writes, and, on the "kernels" backend, one [B] int32 device tensor that
    every layer's decode-attention kernel reads as it is."""
    plan = _plan(cfg)
    x = _embed(cfg, params, token, embed)
    B = x.shape[0]
    kernels = cfg.attn_backend == "kernels" and any(
        spec["mixer"] == "attn" for spec in plan)
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
    """Zero caches: a tuple with one dict per layer of the period,
    {"attn": {"k", "v"}} (leaves [n_groups, batch, S, KV, hd]) for an
    attention layer, {"ssm": {"ssm", "conv"}} (leaves [n_groups, batch, H,
    N, P] fp32 and [n_groups, batch, W-1, conv_dim]) for a mamba layer."""
    dev = resolve_device(device)
    lead = (cfg.n_groups,)

    def one_layer(spec):
        if spec["mixer"] == "attn":
            return {"attn": L.init_attn_cache(cfg, batch, cache_len,
                                              device=dev, lead=lead)}
        return {"ssm": M.init_ssm_cache(cfg, batch, device=dev, lead=lead)}
    return tuple(one_layer(spec) for spec in _plan(cfg))


def param_count(params):
    return sum(x.numel() for x in tree_leaves(params))
