"""Public ops around the CUDA kernels, dispatched by the inputs' device.

A CPU tensor runs the kernel's plain PyTorch version (``kernels/ref.py``); a
CUDA tensor launches the hand-written kernel, and a failed build or launch
raises — nothing falls back.  Each op keeps the reference's trick of folding
the missing index into data (an availability-masked coefficient vector), so
one kernel serves every missing pattern.  Launch counts live on the kernel
wrappers (``counters()``).

No kernel has a backward (nor has any of the JAX package's Pallas kernels),
so every op raises ``RuntimeError`` when asked for a gradient: grad mode on
and a tensor input requiring grad.  It raises on the CPU as well, where the
plain version would differentiate, so a training forward routed through an
op fails in the CPU tests instead of training without that gradient on the
card.  Training differentiates the plain paths (``attn_backend="torch"``,
``scheme.encode_with_params``); forwards under ``torch.no_grad()`` or
``torch.inference_mode()`` run the kernels.

Nor does any kernel take a ``DTensor`` (a tensor sharded over a device
mesh): every op raises ``RuntimeError`` on one, on both devices, rather
than run on a local shard or fall back to a plain version.  On a mesh of one
device the launch steps hand the ops plain tensors; kernels over the local
shards of a sharded mesh are ``ROADMAP.md`` B.4.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref
from repro_torch.kernels import berrut_encoder as _berrut
from repro_torch.kernels import decode_attention as _decode_attn
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_encode_forward as _fused_ef
from repro_torch.kernels import learned_encoder as _project
from repro_torch.kernels import multigroup_decode as _mg_decode
from repro_torch.kernels import parity_decode as _decode
from repro_torch.kernels import parity_encode as _encode


def counters():
    """The kernels' launch counters, by kernel name (B3 and B6 share B4's
    and B5's kernel but count their own launches)."""
    return {m.launches.name: m.launches
            for m in (_encode, _fused_ef, _decode, _mg_decode, _project,
                      _berrut, _flash, _decode_attn)}


def _on_card(t):
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _no_backward(name, *xs):
    """Raise when ``name`` is asked for a gradient (see the module's
    docstring)."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name} has no backward: differentiate through the plain path "
            "(cfg.replace(attn_backend='torch'), backend='torch' or "
            "scheme.encode_with_params), or run this forward under "
            "torch.no_grad()")


def _no_dtensor(name, *xs):
    """Raise when ``name`` is handed a DTensor (see the module's
    docstring)."""
    if any(isinstance(x, DTensor) for x in xs):
        raise RuntimeError(
            f"{name} takes no DTensor: the kernels run on plain tensors (a "
            "mesh of one device, or attn_backend='torch' on a sharded mesh);"
            " kernels over local shards are ROADMAP.md B.4")


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def parity_encode_op(queries, coeffs):
    """queries [k, B, ...] (any trailing feature shape); coeffs [k]."""
    _no_backward("parity_encode_op", queries, coeffs)
    _no_dtensor("parity_encode_op", queries, coeffs)
    k, B = queries.shape[:2]
    flat = queries.reshape(k, B, -1)
    c = _f32(coeffs, flat.device)
    if _on_card(flat):
        out = _encode.parity_encode(flat.contiguous(), c.contiguous())
    else:
        out = ref.parity_encode_ref(flat, c)
    return out.reshape((B,) + tuple(queries.shape[2:]))


def parity_decode_op(parity_out, outputs, missing_idx, coeffs=None):
    """parity_out [B, V]; outputs [k, B, V]; missing_idx python int;
    coeffs [k] host values (None, numpy, a list or a CPU tensor; None is
    the sum code).  The k + 1 decode coefficients are computed here on the
    host with the reference's formula (avail_i = c_i [i != j],
    inv_c = 1 / c_j), so the card sees one launch; a CUDA ``coeffs`` raises
    ``TypeError``."""
    _no_backward("parity_decode_op", parity_out, outputs, coeffs)
    _no_dtensor("parity_decode_op", parity_out, outputs, coeffs)
    j = int(missing_idx)
    if coeffs is None:
        avail, inv_c = np.ones(outputs.shape[0], np.float32), np.float32(1.0)
    else:
        avail = _decode.host_floats(coeffs, "parity_decode_op").copy()
        inv_c = np.float32(1.0) / avail[j]
    avail[j] *= 0                  # c_j [j != j], its sign kept as c_j * 0
    if _on_card(outputs):
        return _decode.parity_decode(parity_out.contiguous(),
                                     outputs.contiguous(), avail, inv_c)
    return ref.parity_decode_ref(parity_out, outputs, torch.from_numpy(avail),
                                 inv_c)


def fused_encode_forward_op(queries, coeffs, weights):
    """Fused coded hot path: encode + the first parity-forward matmul in one
    launch.  queries [k, B, ...] (any trailing feature shape, flattened to
    F); coeffs [r, k]; weights [r, F, V] — one first-layer matrix per parity
    row — returns [r, B, V]."""
    _no_backward("fused_encode_forward_op", queries, coeffs, weights)
    _no_dtensor("fused_encode_forward_op", queries, coeffs, weights)
    k, B = queries.shape[:2]
    flat = queries.reshape(k, B, math.prod(queries.shape[2:]))   # F may be 0
    C = _f32(coeffs, flat.device)
    if _on_card(flat):
        return _fused_ef.fused_encode_forward(
            flat.contiguous(), C.contiguous(), weights.contiguous())
    return ref.fused_encode_forward_ref(flat, C, weights)


def multigroup_decode_op(parity_outs, outputs, missing_idxs, coeffs):
    """Batched r=1 subtraction decode over G stacked groups in one launch.

    parity_outs [G, B, V...] (axis 1 is batch when present: [G, V...] inputs
    are treated as batch 1); outputs [G, k, B, V...]; missing_idxs [G] ints;
    coeffs [k] (shared) or [G, k] (per-group).  Returns reconstructions
    shaped like ``parity_outs``."""
    _no_backward("multigroup_decode_op", parity_outs, outputs, coeffs)
    _no_dtensor("multigroup_decode_op", parity_outs, outputs, coeffs)
    G, k = outputs.shape[:2]
    dev = outputs.device
    if parity_outs.ndim >= 3:
        B = parity_outs.shape[1]
        po = parity_outs.reshape(G, B, -1)
        outs = outputs.reshape(G, k, B, -1)
    else:
        po = parity_outs.reshape(G, 1, -1)
        outs = outputs.reshape(G, k, 1, -1)
    idx = torch.as_tensor(missing_idxs, dtype=torch.long, device=dev)
    c = _f32(coeffs, dev)
    if c.ndim == 1:
        c = c[None].expand(G, k)
    avail = c * (torch.arange(k, device=dev)[None, :] != idx[:, None])
    inv = 1.0 / torch.gather(c, 1, idx[:, None])                 # [G, 1]
    cmat = torch.cat([avail, inv], dim=1)                        # [G, k+1]
    if _on_card(outs):
        out = _mg_decode.multigroup_decode(po.contiguous(), outs.contiguous(),
                                           cmat.contiguous())
    else:
        out = ref.multigroup_decode_ref(po, outs, cmat)
    return out.reshape(parity_outs.shape)


def berrut_encode_op(queries, coeffs):
    """Approxifer encode projection: queries [k, B, ...] (any trailing
    feature shape); coeffs [r, k] -> [r, B, ...], one launch for all r."""
    _no_backward("berrut_encode_op", queries, coeffs)
    _no_dtensor("berrut_encode_op", queries, coeffs)
    k, B = queries.shape[:2]
    flat = queries.reshape(k, B, -1)
    c = _f32(coeffs, flat.device)
    if _on_card(flat):
        out = _berrut.berrut_encode(flat.contiguous(), c.contiguous())
    else:
        out = ref.learned_project_ref(flat, c.T)
    return out.reshape((c.shape[0], B) + tuple(queries.shape[2:]))


def learned_project_op(h, w):
    """Learned-encoder final projection: h [H, B, ...] (any trailing feature
    shape); w [H, r] -> [r, B, ...]."""
    _no_backward("learned_project_op", h, w)
    _no_dtensor("learned_project_op", h, w)
    hd, B = h.shape[:2]
    flat = h.reshape(hd, B, -1)
    wf = _f32(w, flat.device)
    if _on_card(flat):
        out = _project.learned_project(flat.contiguous(), wf.contiguous())
    else:
        out = ref.learned_project_ref(flat, wf)
    return out.reshape((wf.shape[1], B) + tuple(h.shape[2:]))


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy where a view is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_op(q, k, v, *, causal=True, window=0):
    """Prefill attention: q [B,Sq,H,hd]; k,v [B,Sk,KV,hd] -> [B,Sq,H,hd];
    query row i sits at position i (no q_offset).  Training runs attention
    on the "torch" backend (``models.layers.flash_attention_xla``, the
    custom VJP)."""
    _no_backward("flash_attention_op", q, k, v)
    _no_dtensor("flash_attention_op", q, k, v)
    if _on_card(q):
        return _flash.flash_attention(_aligned(q), _aligned(k), _aligned(v),
                                      causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention_op(q, k_cache, v_cache, pos):
    """One-token decode attention: q [B,H,hd]; caches [B,S,KV,hd]; pos a
    scalar or [B] per-row positions (int, numpy or tensor); valid slots
    j <= pos[b]."""
    _no_backward("decode_attention_op", q, k_cache, v_cache)
    _no_dtensor("decode_attention_op", q, k_cache, v_cache)
    if not _on_card(q):
        return ref.decode_attention_ref(q, k_cache, v_cache, pos)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=q.device, dtype=torch.int32)
    elif isinstance(pos, (int, np.integer)):
        pos = torch.full((), int(pos), dtype=torch.int32, device=q.device)
    else:
        pos = torch.as_tensor(np.asarray(pos, np.int32), device=q.device)
    return _decode_attn.decode_attention(_aligned(q), _aligned(k_cache),
                                         _aligned(v_cache), pos)
