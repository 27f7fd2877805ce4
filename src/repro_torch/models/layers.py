"""Core transformer layers: norms, RoPE, GQA attention (prefill / decode,
cross attention), the MLP — the JAX package's ``models/layers.py``.

All functions take plain dict trees of tensors, with the JAX package's
layouts (dense weights [in, out]).  Attention routes by ``backend`` (default
``cfg.attn_backend``):

* ``"kernels"`` — ``kernels.ops.flash_attention_op`` for prefill and
  ``decode_attention_op`` for decode: the CUDA kernels on CUDA tensors, their
  plain versions on CPU tensors.  A prefill with ``q_offset != 0`` takes the
  online-softmax path, because the kernel lacks that feature;
* ``"torch"`` — the online-softmax KV-block scan (``flash_attention_xla``,
  with the JAX package's custom VJP) and ``attention_decode_xla``, twins of
  the JAX package's "jnp" paths.  Training differentiates this path only.

Cross attention (to modality embeddings or their cached K/V) and the
encoder's bidirectional attention take the non-causal block scan on both
backends, as in the reference, whose flash kernel covers causal self
attention only.

Activations carry the reference's logical sharding constraints
(``distributed.logical.constrain``): the identity without launcher rules
(one card, the unit tests), a DTensor redistribution under them.  Where a
sharded width is reshaped into heads (q/k/v, the GQA group split) or heads
back into a width (before ``wo``), the constraint comes *before* the
reshape, its divisibility guard reading the head count: DTensor cannot
split a width sharded 16 ways into 14 heads, where GSPMD reshards on its
own.  The block scan runs on each rank's local shard of the batch and the
KV heads (``_local_heads``), and so do the kernels on DTensors: B7 through
the same ``_local_heads``, B8 through ``_decode_kernel`` (the ops take
plain tensors only, and get each rank's local shard).

Decode writes the new key/value row into the cache IN PLACE (the JAX
package rebinds an immutable pool): callers that need the old cache clone
it.  The vector-``pos`` write is an ``index_put_`` of one row per batch row,
so every other row stays bit-identical.  A cache that is a DTensor (sharded
along its sequence by ``ShardingRules.cache_specs``) takes an elementwise
select over a slot mask on each rank's shard instead (``_write_slot``):
DTensor would run a slice assignment on a gathered copy and refuses an
``index_put_`` that needs a placement change.  Decode attention over such a
cache keeps its scores on their sequence shards (``_decode_sharded``): a
local max and sum, all-reduced, as flash decoding combines its splits.  On
the "kernels" backend a DTensor cache keeps its sequence whole on each rank
(the serving pool's layout), and the new row is written by an
``index_put_`` into each rank's local cache inside B8's ``local_map``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ATTN_BACKENDS
from repro_torch.distributed import logical
from repro_torch.distributed.logical import constrain

NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg):
    return _DTYPES[cfg.dtype]


def _backend(cfg, backend):
    backend = backend or cfg.attn_backend
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"attention backend must be one of {ATTN_BACKENDS}, "
                         f"got {backend!r}")
    return backend


def split_heads(t, n, hd, name="heads"):
    """[B, S, n*hd] -> [B, S, n, hd], constrained first so that a sharded
    width splits into whole heads (``name`` the heads' logical axis)."""
    B, S = t.shape[:2]
    t = constrain(t, ("batch", None, name), shape=(B, S, n))
    return t.reshape(B, S, n, hd)


def merge_heads(o):
    """[B, S, H, hd] -> [B, S, H*hd], heads constrained first."""
    B, S, H, hd = o.shape
    o = constrain(o, ("batch", None, "heads", None))
    return o.reshape(B, S, H * hd)


def group_heads(q, KV):
    """[B, S, H, hd] -> [B, S, KV, rep, hd] (GQA groups), the query heads
    constrained first by the KV-head count."""
    B, S, H, hd = q.shape
    q = constrain(q, ("batch", None, "kv_heads", None), shape=(B, S, KV, hd))
    return constrain(q.reshape(B, S, KV, H // KV, hd),
                     ("batch", None, "kv_heads", None, None))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(x, scale=None, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(dt)


def nonparametric_layer_norm(x, eps=1e-5):
    """OLMo-style LayerNorm without learned scale/bias."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def make_norm(cfg, d, *, device="cpu", lead=()):
    """Norm parameters: {} for the non-parametric LayerNorm, else a unit
    scale (``lead`` prepends stacked axes)."""
    if cfg.nonparametric_ln:
        return {}
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch_dtype(cfg),
                                device=device)}


def apply_norm(cfg, p, x):
    if cfg.nonparametric_ln:
        return nonparametric_layer_norm(x)
    return rms_norm(x, p["scale"])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_tables(positions, head_dim, theta):
    """positions [S] -> cos/sin [S, head_dim//2] (float32)."""
    half = head_dim // 2
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=dev) / half))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, c, s):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(x, cos, sin):
    """x [B, S, H, hd]; cos/sin [S, hd//2]."""
    return _rotate(x, cos[None, :, None, :].to(x.dtype),
                   sin[None, :, None, :].to(x.dtype))


def apply_rope_rows(x, cos, sin):
    """x [B, 1, H, hd]; cos/sin [B, hd//2] — one angle per batch row (the
    per-slot decode path: each cache slot sits at its own position)."""
    return _rotate(x, cos[:, None, None, :].to(x.dtype),
                   sin[:, None, None, :].to(x.dtype))


# --------------------------------------------------------------------------
# Attention (online-softmax KV-block scan)
# --------------------------------------------------------------------------
def _block_mask(qpos, kpos, Sk, causal, window):
    valid = kpos[None, :] < Sk
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    return valid


def flash_attention_xla(q, k, v, *, causal=True, window=0, q_offset=0,
                        block=1024):
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd] -> [B,Sq,H,hd].  Keyword-friendly
    wrapper over the custom-VJP core (:class:`_FlashCore`); on DTensors
    under launcher rules, per shard (:func:`_local_heads`), which takes the
    place of the reference's constraints on the scan's carries."""
    def core(q, k, v):
        return _FlashCore.apply(q, k, v, causal, window, q_offset, block)
    return _local_heads(core, q, k, v)


def _local_heads(fn, q, k, v):
    """``fn(q, k, v)``, on each rank's local shard of the batch and the KV
    heads when the inputs are DTensors under launcher rules: attention is
    independent per (batch row, KV head), and the query heads shard by the
    KV-head count (the reference's constraint on the grouped query).  The
    scan then runs on plain local tensors, forward and backward; DTensor
    would instead flatten a sharded head dimension into its batched
    products, which torch 2.11 refuses."""
    if logical.state()[0] is None or not isinstance(q, DTensor):
        return fn(q, k, v)
    B, Sq, _, hd = q.shape
    spec = logical.logical_spec((B, Sq, k.shape[2], hd),
                                ("batch", None, "kv_heads", None))
    pl = logical.placements(spec, q.device_mesh)
    # a list: local_map reads a tuple as one placement per output
    return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def _flash_fwd_impl(q, k, v, causal, window, q_offset, block):
    """The JAX package's block scan: KV blocks carrying an fp32 (max, denom,
    acc), GQA as grouped einsums over the un-repeated K/V, q scaled in its
    own dtype, scores and the P.V product accumulated in fp32 with P cast to
    V's dtype.  Returns (out, lse), lse [B,KV,rep,Sq] the log-sum-exp of
    each query row's scaled scores."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    block = min(block, Sk)
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    qs = (q.reshape(B, Sq, KV, rep, hd) * scale).float()
    m = torch.full((B, KV, rep, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, rep, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, rep, Sq, hd), dtype=torch.float32, device=dev)
    for start in range(0, Sk, block):
        kblk, vblk = k[:, start:start + block], v[:, start:start + block]
        kpos = start + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qs, kblk.float())
        valid = _block_mask(qpos, kpos, Sk, causal, window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, window, q_offset,
                    block):
    """The JAX package's ``_flash_bwd``: block scores are recomputed from
    q, k and lse (nothing of size [nb, B, H, Sq, block] is kept), delta =
    rowsum(dO * O), dV sums over the rep query heads of a KV head, dq is
    scaled once at the end.  fp32 throughout; the results in the inputs'
    dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    blk = min(block, Sk)
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    qs = (q.reshape(B, Sq, KV, rep, hd) * scale).float()
    do = dout.reshape(B, Sq, KV, rep, hd).permute(0, 2, 3, 1, 4).float()
    o32 = out.reshape(B, Sq, KV, rep, hd).permute(0, 2, 3, 1, 4).float()
    delta = (do * o32).sum(-1)                            # [B,KV,rep,Sq]
    dq = torch.zeros((B, Sq, KV, rep, hd), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for start in range(0, Sk, blk):
        kblk = k[:, start:start + blk].float()            # [B,blk,KV,hd]
        vblk = v[:, start:start + blk].float()
        kpos = start + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qs, kblk)
        valid = _block_mask(qpos, kpos, Sk, causal, window)
        s = torch.where(valid, s, NEG_INF)
        p = torch.exp(s - lse[..., None])                 # [B,KV,rep,Sq,bk]
        dvs.append(torch.einsum("bgrqk,bgrqd->bkgd", p, do))
        dp = torch.einsum("bgrqd,bkgd->bgrqk", do, vblk)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bgrqk,bkgd->bqgrd", ds, kblk)
        dks.append(torch.einsum("bgrqk,bqgrd->bkgd", ds, qs))
    dq = (dq * scale).reshape(B, Sq, H, hd).to(q.dtype)
    return (dq, torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashCore(torch.autograd.Function):
    """The block scan with the JAX package's custom VJP (``_flash_core``):
    the forward saves (q, k, v, out, lse), O(S*d), and the backward
    recomputes the block scores instead of keeping the scan's
    exp(s - m) residuals.  Both passes are plain PyTorch: the JAX package
    differentiates only this scan (its flash kernel, B7, has no backward,
    and ``kernels.ops.flash_attention_op`` refuses a gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset, block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (causal, window, q_offset, block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, *ctx.static)
        return dq, dk, dv, None, None, None, None


def attention_decode_xla(q, k_cache, v_cache, pos, *, window=0):
    """Single-token decode attention. q [B,1,H,hd]; caches [B,S,KV,hd];
    pos a python int (number of valid cached tokens is pos+1) or a [B]
    tensor of per-row positions (slot-batched decode).

    With a sliding window the cache is a ring buffer of size ``window``; the
    mask then covers every slot already written."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    # the cache shards its sequence dim over whatever mesh axes the batch
    # leaves (decode_32k: batch->data, seq->model); kv-heads stay local and
    # GQA is a grouped einsum
    k_cache = constrain(k_cache, ("batch", "seq", "kv_heads", None))
    v_cache = constrain(v_cache, ("batch", "seq", "kv_heads", None))
    qg = group_heads(q, KV)[:, 0] * hd ** -0.5
    kpos = torch.arange(S, device=q.device)
    if isinstance(pos, torch.Tensor) and pos.ndim:     # per-row [B]
        pos = pos.to(q.device)
        if window:
            valid = kpos[None, :] < torch.clamp(pos + 1, max=S)[:, None]
        else:
            valid = kpos[None, :] <= pos[:, None]
    else:
        pos = int(pos)
        valid = kpos < min(pos + 1, S) if window else kpos <= pos
    if isinstance(k_cache, DTensor):
        out = _decode_sharded(qg, k_cache, v_cache,
                              valid.expand(B, S).contiguous())
        return out.reshape(B, 1, H, hd).to(q.dtype)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float())
    if valid.ndim == 2:
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    else:
        s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def pad_seq(t, before, after):
    """``t`` [B, S, ...] with zero rows padded along S.  A DTensor whose S
    is whole on every rank pads each rank's shard: torch 2.11's
    redistribution planner fails on ``F.pad`` of a DTensor."""
    widths = (0, 0) * (t.ndim - 2) + (before, after)
    if isinstance(t, DTensor) and Shard(1) not in t.placements:
        pl = list(t.placements)
        return local_map(lambda x: F.pad(x, widths), out_placements=pl,
                         in_placements=(pl,), device_mesh=t.device_mesh)(t)
    return F.pad(t, widths)


def _replicated(t, mesh):
    """A plain tensor that every rank holds whole, as a replicated DTensor
    (``local_map`` then slices it locally, with no collective)."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _decode_sharded(qg, k_cache, v_cache, valid):
    """:func:`attention_decode_xla` on a DTensor cache [B, S, KV, hd] whose
    batch, sequence and KV heads may each be sharded: each rank scores its
    own slots, and the softmax's max and sum and the P.V product are
    all-reduced over the mesh dimensions that shard the sequence (the
    reference's compiled step keeps the scores sharded in the same way).
    ``qg`` [B, KV, rep, hd] (scaled), ``valid`` [B, S] -> [B, KV, rep, hd]
    fp32."""
    mesh, pl = k_cache.device_mesh, tuple(k_cache.placements)
    seq_dims = [i for i, p in enumerate(pl) if p == Shard(1)]
    # per mesh dim: the query and the output follow the cache's batch and
    # KV-head sharding (dims 0 and 2 of the cache, 0 and 1 of the query)
    q_pl = [Shard({0: 0, 2: 1}[p.dim]) if p.is_shard() and p.dim != 1
            else Replicate() for p in pl]
    valid_pl = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
                for p in pl]

    def reduce(t, op):
        for d in seq_dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
        return t

    def local(q, k, v, ok):
        s = torch.einsum("bgrd,bkgd->bgrk", q.float(), k.float())
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        e = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
        p = e / reduce(e.sum(dim=-1, keepdim=True), "sum")
        return reduce(torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype).float(),
                                   v.float()), "sum")
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, pl, pl, valid_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        qg, k_cache, v_cache, _replicated(valid, mesh))


# --------------------------------------------------------------------------
# Attention layer (params + forward)
# --------------------------------------------------------------------------
def _dense(gen, shape, dtype, device, lead=()):
    """N(0, 1/fan_in) weights, as the JAX package's ``dense`` draws them
    (fan_in = shape[0]); ``lead`` prepends stacked axes."""
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen, device=device)
    return (w / math.sqrt(shape[0])).to(dtype)


def init_attention(cfg, gen, cross=False, *, device="cpu", lead=()):
    """Attention parameters; ``cross`` adds the ``cross_norm`` scale that
    the cross-attention branch normalises its input with."""
    D, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg)

    def zeros(n):
        return torch.zeros(tuple(lead) + (n,), dtype=dt, device=device)

    def ones(n):
        return torch.ones(tuple(lead) + (n,), dtype=dt, device=device)

    p = {
        "wq": _dense(gen, (D, H * hd), dt, device, lead),
        "wk": _dense(gen, (D, KV * hd), dt, device, lead),
        "wv": _dense(gen, (D, KV * hd), dt, device, lead),
        "wo": _dense(gen, (H * hd, D), dt, device, lead),
        "norm": make_norm(cfg, D, device=device, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(H * hd), zeros(KV * hd), \
            zeros(KV * hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = ones(hd), ones(hd)
    if cross:
        p["cross_norm"] = make_norm(cfg, D, device=device, lead=lead)
    return p


def _qkv(cfg, p, xq, xkv):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, H, hd)
    k = split_heads(k, KV, hd, "kv_heads")
    v = split_heads(v, KV, hd, "kv_heads")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def self_attention_fwd(cfg, p, x, rope_cs, *, window=0, q_offset=0,
                       backend=None):
    """Causal self attention for prefill. Returns (out, (k, v)).

    ``backend`` overrides ``cfg.attn_backend``: "kernels" routes through the
    flash-attention op where it covers the case (q_offset == 0); otherwise —
    and always for "torch" — the online-softmax path runs."""
    backend = _backend(cfg, backend)
    q, k, v = _qkv(cfg, p, x, x)
    cos, sin = rope_cs
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if backend == "kernels" and not q_offset:
        from repro_torch.kernels import ops as kernel_ops
        o = _local_heads(lambda q, k, v: kernel_ops.flash_attention_op(
            q, k, v, causal=True, window=window), q, k, v)
    else:
        o = flash_attention_xla(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
    return merge_heads(o) @ p["wo"], (k, v)


def cross_attention_fwd(cfg, p, x, kv_or_embeds, *, from_cache=False):
    """Cross attention to modality embeddings [B, S_ctx, D] (or, with
    ``from_cache``, to their cached (k, v) [B, S_ctx, KV, hd]): no RoPE, no
    mask.  Returns (out, (k, v))."""
    if from_cache:
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        q = split_heads(q, cfg.n_heads, cfg.resolved_head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        k, v = kv_or_embeds
    else:
        q, k, v = _qkv(cfg, p, x, kv_or_embeds)
    o = flash_attention_xla(q, k, v, causal=False)
    return merge_heads(o) @ p["wo"], (k, v)


def self_attention_decode(cfg, p, x, cache, pos, rope_cs, *, window=0,
                          backend=None, kernel_pos=None):
    """One-token decode. x [B,1,D]; cache {'k','v'} ring buffers [B,S,KV,hd],
    written in place.

    ``pos`` is a python int (whole batch at one position) or a [B] tensor
    (slot-batched streams, each at its own position — ``rope_cs`` then holds
    per-row tables [B, hd//2]).  ``backend`` as in
    :func:`self_attention_fwd`.  ``kernel_pos``, where given, is what the
    decode-attention kernel reads for ``pos`` (an int32 [B] tensor made once
    per step by ``transformer.decode_step``).  Returns (out, cache)."""
    backend = _backend(cfg, backend)
    q, k, v = _qkv(cfg, p, x, x)
    cos, sin = rope_cs
    vector = isinstance(pos, torch.Tensor) and pos.ndim > 0
    if vector:
        q = apply_rope_rows(q, cos, sin)
        k = apply_rope_rows(k, cos, sin)
    else:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k_cache, v_cache = cache["k"], cache["v"]
    S = k_cache.shape[1]
    pos = pos.to(device=x.device, dtype=torch.long) if vector else int(pos)
    slot = pos % S if window else pos
    kpos = pos if kernel_pos is None else kernel_pos
    if backend == "kernels" and isinstance(k_cache, DTensor):
        # the row written and attended over in one local_map
        o = _decode_kernel(q[:, 0], k_cache, v_cache, kpos,
                           rows=(k[:, 0], v[:, 0], slot))
        return merge_heads(o[:, None].to(q.dtype)) @ p["wo"], cache
    if isinstance(k_cache, DTensor):
        _write_slot(k_cache, k, slot)
        _write_slot(v_cache, v, slot)
    elif vector:
        # one row per batch row: the others stay bit-identical
        rows = torch.arange(pos.shape[0], device=x.device)
        k_cache.index_put_((rows, slot), k[:, 0])
        v_cache.index_put_((rows, slot), v[:, 0])
    else:
        k_cache[:, slot:slot + 1] = k
        v_cache[:, slot:slot + 1] = v
    if backend == "kernels":
        o = _decode_kernel(q[:, 0], k_cache, v_cache, kpos)
        o = o[:, None].to(q.dtype)
    else:
        o = attention_decode_xla(q, k_cache, v_cache, pos, window=window)
    return merge_heads(o) @ p["wo"], cache


def _decode_kernel(q, k_cache, v_cache, pos, rows=None):
    """``kernels.ops.decode_attention_op`` (q [B, H, hd]), and on a DTensor
    cache on each rank's shard of the batch and the KV heads: the query's
    heads shard as the cache's KV heads do (whole GQA groups, as
    ``group_heads`` constrains them), the positions as its batch, and the
    sequence stays whole on each rank.  ``rows`` (the new key and value
    rows [B, KV, hd] and their slot, an int or a [B] tensor) are first
    written into the shard's cache in place, in the same ``local_map``: one
    row per batch row, an ``index_put_`` into the local tensor that is the
    pool's own storage.  A cache sharded along its sequence raises
    ``ValueError``: B8 returns no log-sum-exp that the shards' partial
    softmaxes could be combined with (``ROADMAP.md`` B.5); the "torch"
    backend serves such a cache (``_decode_sharded``)."""
    from repro_torch.kernels import ops as kernel_ops
    if not isinstance(k_cache, DTensor):
        return kernel_ops.decode_attention_op(q, k_cache, v_cache, pos)
    mesh, pl = k_cache.device_mesh, tuple(k_cache.placements)
    if any(p.is_shard() and p.dim not in (0, 2) for p in pl):
        raise ValueError(
            f"the decode-attention kernel runs on whole sequences: a cache "
            f"placed {pl} shards its sequence or head dim over the mesh; "
            f"serve it on attn_backend='torch' (ROADMAP.md B.5)")
    q_pl = [Shard({0: 0, 2: 1}[p.dim]) if p.is_shard() else Replicate()
            for p in pl]
    pos_pl = [p if p == Shard(0) else Replicate() for p in pl]
    B = q.shape[0]

    def per_row(t, dtype):
        if isinstance(t, torch.Tensor) and t.ndim:
            return t.to(dtype)
        return torch.full((B,), int(t), dtype=dtype, device=k_cache.device)
    args = [q, k_cache, v_cache, _replicated(per_row(pos, torch.int32), mesh)]
    if rows is None:
        return local_map(kernel_ops.decode_attention_op, out_placements=q_pl,
                         in_placements=(q_pl, pl, pl, pos_pl),
                         device_mesh=mesh, redistribute_inputs=True)(*args)

    def write_and_attend(q, kc, vc, p, kr, vr, slot):
        i = torch.arange(kc.shape[0], device=kc.device)
        kc.index_put_((i, slot), kr)
        vc.index_put_((i, slot), vr)
        return kernel_ops.decode_attention_op(q, kc, vc, p)
    kr, vr, slot = rows
    return local_map(write_and_attend, out_placements=q_pl,
                     in_placements=(q_pl, pl, pl, pos_pl, q_pl, q_pl, pos_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        *args, kr.to(k_cache.dtype), vr.to(v_cache.dtype),
        _replicated(per_row(slot, torch.long), mesh))


def _write_slot(cache, row, slot):
    """``cache[b, slot[b]] = row[b, 0]`` for every batch row b (``slot`` an
    int or a [B] tensor) on a DTensor cache [B, S, KV, hd], in place and
    without a placement change: on each rank's shard, an elementwise select
    over a slot mask, then ``copy_`` between tensors placed alike.  The new
    row takes the cache's placements with the sequence replicated (one slot
    has nothing to shard)."""
    B, S = cache.shape[:2]
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    kpos = torch.arange(S, device=row.device)
    if isinstance(slot, torch.Tensor):
        hit = kpos[None, :] == slot[:, None]
    else:
        hit = (kpos == slot)[None, :].expand(B, S)
    row_pl = [Replicate() if p == Shard(1) else p for p in pl]
    # the mask [B, S, 1, 1] shards as the cache's batch and sequence only
    hit_pl = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
              for p in pl]
    new = local_map(lambda c, r, m: torch.where(m, r, c),
                    out_placements=list(pl),
                    in_placements=(pl, row_pl, hit_pl),
                    device_mesh=mesh, redistribute_inputs=True)(
        cache, row.to(cache.dtype),
        _replicated(hit[:, :, None, None].contiguous(), mesh))
    cache.copy_(new)


def init_attn_cache(cfg, batch, seq_len, *, device="cpu", lead=()):
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = tuple(lead) + (batch, S, KV, hd)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(cfg, gen, d_ff=None, *, device="cpu", lead=()):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    dt = torch_dtype(cfg)
    p = {"w1": _dense(gen, (D, Fd), dt, device, lead),
         "w2": _dense(gen, (Fd, D), dt, device, lead),
         "norm": make_norm(cfg, D, device=device, lead=lead)}
    if cfg.act == "silu":                 # SwiGLU
        p["w3"] = _dense(gen, (D, Fd), dt, device, lead)
    return p


def mlp_fwd(cfg, p, x):
    h = x @ p["w1"]
    if cfg.act == "silu":
        h = F.silu(h) * (x @ p["w3"])
    elif cfg.act == "relu":
        h = F.relu(h)
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return h @ p["w2"]
