"""Model assembly for every layer plan of the JAX package's
``models/transformer.py``: dense, MoE, SSM (Mamba2) and hybrid (Jamba)
decoder stacks, the VLM's cross-attention layers (llama-3.2-vision) and the
encoder-decoder plan (seamless-m4t).

A model is a stack of ``n_layers`` layers with a repeating superblock of
length ``cfg.period``.  As in the reference, the parameters of the
superblocks are stacked along a leading "group" axis: ``params["blocks"]``
is a tuple with one dict per layer of the period, and every leaf carries a
leading ``n_groups`` axis, so a JAX parameter or cache tree carried over by
``convert.params_from_numpy`` is a tree of this module.  ``jax.lax.scan``
over the groups becomes a Python loop over that axis.  An encoder-decoder
model also holds ``params["encoder"] = {"blocks", "final_norm"}``, the same
layout over ``n_enc_layers // period`` groups.

Each layer of the period is a spec of ``layer_plan``: a mixer (``attn``,
``mamba``, or ``none`` for the VLM's cross-attention layer), whether it
cross-attends, an FFN (``mlp``, ``moe`` or none), and whether its attention
is causal (the encoder's is not), with the reference's per-spec parameter
keys.  Cross attention reads ``cross_embeds``: the stub patch embeddings
[B, n_ctx, D] of a VLM, or the encoder's output over the stub frame
embeddings [B, S_src, D] that an encoder-decoder model takes in their place
(``run_encoder``).  Cross attention and the encoder's bidirectional
attention run the non-causal block scan on both backends, as in the
reference.

Three entry points per model:
  * ``forward``      — full-sequence teacher-forced logits and the MoE
                       router loss summed over layers
  * ``prefill``      — full-sequence + returns per-layer KV / SSM caches
                       and the cross-attention K/V of the context
  * ``decode_step``  — one token through the cached stack (serving decode;
                       writes the key/value rows, SSM states and conv tails
                       into the caches in place, and only reads the cross
                       K/V)
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import resolve_device, tree_leaves
from repro_torch.distributed.logical import constrain, constrain_spec
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


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_layer(cfg, gen, spec, *, device="cpu", lead=()):
    """One layer of the period: {"attn" | "mamba", "cross", "mlp" | "moe"}
    as the spec says (``lead`` prepends the stacked group axis)."""
    kw = dict(device=device, lead=lead)
    p = {}
    if spec["mixer"] == "attn":
        p["attn"] = L.init_attention(cfg, gen, **kw)
    elif spec["mixer"] == "mamba":
        p["mamba"] = M.init_mamba(cfg, gen, **kw)
    if spec["cross"]:
        p["cross"] = L.init_attention(cfg, gen, cross=True, **kw)
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
    p["blocks"] = _init_stack(cfg, gen, cfg.n_groups, layer_plan(cfg), dev)
    p["final_norm"] = L.make_norm(cfg, D, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((D, V), generator=gen, device=dev)
                        / math.sqrt(D)).to(dt)
    if cfg.enc_dec:
        p["encoder"] = {
            "blocks": _init_stack(cfg, gen, _n_enc_groups(cfg),
                                  layer_plan(cfg, role="encoder"), dev),
            "final_norm": L.make_norm(cfg, D, device=dev)}
    return p


def _init_stack(cfg, gen, n_groups, plan, device):
    return tuple(init_layer(cfg, gen, spec, device=device, lead=(n_groups,))
                 for spec in plan)


def _n_enc_groups(cfg):
    if cfg.n_enc_layers % cfg.period:
        raise ValueError(f"{cfg.name}: {cfg.n_enc_layers} encoder layers do "
                         f"not split into periods of {cfg.period}")
    return cfg.n_enc_layers // cfg.period


# --------------------------------------------------------------------------
# Layers and stack
# --------------------------------------------------------------------------
def _layer_fwd(cfg, spec, p, x, ctx):
    """Full-sequence layer. Returns (x, aux, cache_entry): aux is the MoE
    router loss (a python 0.0 without MoE, which launches nothing), the
    cache entry {"attn": {"k", "v"}} or {"ssm": {"ssm", "conv"}}, and
    {"cross": {"k", "v"}} for a cross-attending layer, when
    ``ctx["collect_cache"]``."""
    aux = 0.0
    cache = {}
    if spec["mixer"] == "attn":
        h = L.apply_norm(cfg, p["attn"]["norm"], x)
        if spec["causal"]:
            o, (k, v) = L.self_attention_fwd(cfg, p["attn"], h, ctx["rope"],
                                             window=ctx["window"])
        else:
            o, (k, v) = _bidir_attn(cfg, p["attn"], h, ctx)
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
    if spec["cross"]:
        h = L.apply_norm(cfg, p["cross"]["cross_norm"], x)
        o, (ck, cv) = L.cross_attention_fwd(cfg, p["cross"], h,
                                            ctx["cross_embeds"])
        x = x + o
        if ctx["collect_cache"]:
            cache["cross"] = {"k": ck, "v": cv}
    if spec["ffn"] == "mlp":
        h = L.apply_norm(cfg, p["mlp"]["norm"], x)
        x = x + L.mlp_fwd(cfg, p["mlp"], h)
    elif spec["ffn"] == "moe":
        h = L.apply_norm(cfg, p["moe"]["norm"], x)
        o, aux = MOE.moe_fwd(cfg, p["moe"], h)
        x = x + o
    return x, aux, cache


def _bidir_attn(cfg, p, h, ctx):
    """The encoder's self attention: RoPE on the frame positions, no mask
    (the block scan on both backends)."""
    q, k, v = L._qkv(cfg, p, h, h)
    cos, sin = ctx["rope"]
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = L.flash_attention_xla(q, k, v, causal=False)
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["wo"], (k, v)


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


def _stack_fwd(cfg, stacked, x, ctx, plan, remat=False, n_groups=None):
    """Python loop over the ``n_groups`` groups (default ``cfg.n_groups``);
    returns x, the aux loss summed over layers and groups and, when
    collecting, the caches stacked along a leading group axis as the
    reference's scan stacks them.  ``remat`` checkpoints each group (the
    reference's ``jax.checkpoint`` of the scan body): its activations are
    recomputed in the backward pass instead of kept.  The context in
    ``ctx`` (an encoder's output) is not an argument of the checkpoint; the
    non-reentrant checkpoint carries its gradient all the same."""
    def group(x, g):
        aux = 0.0
        caches = []
        x = constrain(x, ("batch", None, None))
        for i, spec in enumerate(plan):
            x, a, c = _layer_fwd(cfg, spec, _group(stacked[i], g), x, ctx)
            aux = aux + a
            caches.append(c)
        return constrain(x, ("batch", None, None)), aux, caches

    aux = 0.0
    per_group = []
    for g in range(n_groups or cfg.n_groups):
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
    tails are written into ``caches`` in place, the cross-attention K/V are
    only read.  The MoE aux is dropped, as in the reference's decode."""
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
            if spec["cross"]:
                h = L.apply_norm(cfg, p["cross"]["cross_norm"], x)
                kv = _group(caches[i]["cross"], g)
                x = x + L.cross_attention_fwd(cfg, p["cross"], h,
                                              (kv["k"], kv["v"]),
                                              from_cache=True)[0]
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


def _logits(cfg, params, x, logits_pspec=None):
    x = L.apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # keep the fp32 logits vocab-sharded on the tensor axis: unsharded
    # [B*S, V] fp32 logits dominate a train step's memory otherwise
    out = constrain((x @ head).float(), ("batch", None, "vocab"))
    if logits_pspec is not None:
        out = constrain_spec(out, logits_pspec)
    return out


def _rope(cfg, pos):
    """RoPE tables for ``pos``, cast once to the model dtype (the cast
    ``apply_rope`` would make in every layer); (None, None) for an
    attention-free model."""
    if not cfg.n_heads:
        return None, None
    dt = L.torch_dtype(cfg)
    return tuple(t.to(dt) for t in L.rope_tables(
        pos, cfg.resolved_head_dim, cfg.rope_theta))


def _make_ctx(cfg, S, device, *, cross_embeds=None, collect_cache=False,
              cache_len=0):
    pos = torch.arange(S, device=device)
    return {"rope": _rope(cfg, pos), "window": cfg.sliding_window,
            "cross_embeds": cross_embeds, "collect_cache": collect_cache,
            "cache_len": cache_len}


def run_encoder(cfg, params, frames):
    """The encoder over stub frame embeddings [B, S_src, D]: bidirectional
    layers with RoPE on the frame positions, then its final norm."""
    x = frames.to(L.torch_dtype(cfg))
    ctx = _make_ctx(cfg, x.shape[1], x.device)
    x, _, _ = _stack_fwd(cfg, params["encoder"]["blocks"], x, ctx,
                         layer_plan(cfg, role="encoder"),
                         n_groups=_n_enc_groups(cfg))
    return L.apply_norm(cfg, params["encoder"]["final_norm"], x)


def _context(cfg, params, cross_embeds):
    """What the cross-attention layers attend to: the encoder's output over
    ``cross_embeds`` (the frames) for an encoder-decoder model, else the
    embeddings themselves in the model dtype (torch's matmul does not
    promote a float32 context against bf16 weights as jnp's does)."""
    if cross_embeds is None:
        if cfg.enc_dec or cfg.cross_attn_every:
            raise ValueError(f"{cfg.name}: cross-attention layers need "
                             f"cross_embeds (patch or frame embeddings "
                             f"[B, S_ctx, {cfg.d_model}])")
        return None
    if cfg.enc_dec:
        return run_encoder(cfg, params, cross_embeds)
    return cross_embeds.to(L.torch_dtype(cfg))


def forward(cfg, params, tokens=None, embeds=None, cross_embeds=None,
            remat=False, logits_pspec=None, unembed_last_only=False):
    """Teacher-forced full-sequence logits. Returns (logits_f32, aux); aux is
    the MoE router loss summed over layers and groups (0 without MoE).

    ``cross_embeds`` is the context of a cross-attending plan: patch
    embeddings [B, n_ctx, D] (VLM) or frame embeddings [B, S_src, D] that
    the encoder runs over first (encoder-decoder).  ``remat`` recomputes
    each group's activations in the backward pass (training);
    ``unembed_last_only`` skips the [B, S, V] unembed and projects only the
    final position — the serving prefill only consumes the last token.
    ``logits_pspec``, a spec tuple, places the logits on a device mesh
    (``launch.steps.logits_pspec``; nothing without one)."""
    context = _context(cfg, params, cross_embeds)
    x = _embed(cfg, params, tokens, embeds)
    ctx = _make_ctx(cfg, x.shape[1], x.device, cross_embeds=context)
    x, aux, _ = _stack_fwd(cfg, params["blocks"], x, ctx, layer_plan(cfg),
                           remat=remat)
    if unembed_last_only:
        x = x[:, -1:]
    if not isinstance(aux, torch.Tensor):          # no MoE layer
        aux = torch.zeros((), device=x.device)
    return _logits(cfg, params, x, logits_pspec), aux


def prefill(cfg, params, tokens=None, embeds=None, cross_embeds=None,
            cache_len=0):
    """Process the prompt; returns (last-token logits_f32, cache).

    ``cache_len`` reserves decode slots (>= prompt length, or == window for
    sliding-window archs).  ``cross_embeds`` as in :func:`forward`; the
    cross-attention layers' cache entries hold the context's K/V, as many
    rows as the context has (the encoder's output: the frames')."""
    context = _context(cfg, params, cross_embeds)
    x = _embed(cfg, params, tokens, embeds)
    S = x.shape[1]
    if not cache_len:
        cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    ctx = _make_ctx(cfg, S, x.device, cross_embeds=context,
                    collect_cache=True, cache_len=cache_len)
    x, _, caches = _stack_fwd(cfg, params["blocks"], x, ctx, layer_plan(cfg))
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
    every layer's decode-attention kernel reads as it is.  Cross-attending
    layers read the context's K/V from the cache (made by ``prefill`` or
    ``init_cache``) and leave them as they are."""
    plan = layer_plan(cfg)
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
    N, P] fp32 and [n_groups, batch, W-1, conv_dim]) for a mamba layer, and
    {"cross": {"k", "v"}} (leaves [n_groups, batch, n_modality_tokens or 1,
    KV, hd]) for a cross-attending layer, which is all a VLM's
    cross-attention layer (mixer "none") holds."""
    dev = resolve_device(device)
    lead = (cfg.n_groups,)

    def one_layer(spec):
        c = {}
        if spec["mixer"] == "attn":
            c["attn"] = L.init_attn_cache(cfg, batch, cache_len, device=dev,
                                          lead=lead)
        elif spec["mixer"] == "mamba":
            c["ssm"] = M.init_ssm_cache(cfg, batch, device=dev, lead=lead)
        if spec["cross"]:
            shape = lead + (batch, cfg.n_modality_tokens or 1,
                            cfg.n_kv_heads, cfg.resolved_head_dim)
            c["cross"] = {name: torch.zeros(shape, dtype=L.torch_dtype(cfg),
                                            device=dev) for name in "kv"}
        return c
    return tuple(one_layer(spec) for spec in layer_plan(cfg))


def param_count(params):
    return sum(x.numel() for x in tree_leaves(params))
