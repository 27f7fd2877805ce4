"""Mixture-of-Experts FFN — GShard-style top-k routing with fixed expert
capacity, by scatter/gather dispatch (no [T, E, C] one-hot tensor is
materialised): the JAX package's ``models/moe.py`` on one card.

Routing runs in fp32 (``router`` is an fp32 leaf even in a bf16 model), the
top-k gates are renormalised with a 1e-9 floor, and each (token, k)
assignment takes its place within its expert from a cumsum over the
flattened [T*K] order.  Assignments at a place >= the capacity C are
dropped: they are scattered into an overflow row that the expert products
never see, and gathered back as zero.  Nothing here waits on the device
(no boolean indexing, no ``bincount``), so a decode step stays free of host
round trips.

The reference's expert-parallel path (``_moe_fwd_ep``, a ``shard_map`` over
a mesh with a ``model`` axis) is not ported: one card has no mesh.  It waits
for the distributed slice (``ROADMAP.md`` A6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense, make_norm, torch_dtype


def _draw(gen, shape, fan_in, dtype, device, lead=()):
    """N(0, 1/fan_in) weights in ``dtype``, drawn one stacked slice at a
    time: a stacked expert bank of a full-size model (deepseek-moe-16b's
    ``w1`` is [28, 64, 2048, 1408]) never exists as one fp32 draw."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for one in out.view((-1,) + tuple(shape)):
        one.copy_(torch.randn(shape, generator=gen, device=device)
                  / math.sqrt(fan_in))
    return out


def init_moe(cfg, gen, *, device="cpu", lead=()):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg)
    p = {
        # rounded through the model dtype, kept in fp32, as the reference
        # casts its draw
        "router": _draw(gen, (D, E), D, dt, device, lead).float(),
        "w1": _draw(gen, (E, D, Fd), D, dt, device, lead),
        "w3": _draw(gen, (E, D, Fd), D, dt, device, lead),
        "w2": _draw(gen, (E, Fd, D), Fd, dt, device, lead),
        "norm": make_norm(cfg, D, device=device, lead=lead),
    }
    if cfg.n_shared_experts:
        # shared experts fused into one dense SwiGLU of width n_shared * F
        SF = cfg.n_shared_experts * Fd
        p["shared"] = {"w1": _dense(gen, (D, SF), dt, device, lead),
                       "w3": _dense(gen, (D, SF), dt, device, lead),
                       "w2": _dense(gen, (SF, D), dt, device, lead)}
    return p


def expert_capacity(n_tokens, cfg):
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)   # round up to multiple of 8


def route(cfg, router, xt, C):
    """Routing of tokens xt [T, D] over experts of capacity C:
    (gate_vals [T*K] renormalised top-k gates, flat_e [T*K] expert of each
    (token, k) assignment, pos [T*K] its place within the expert, keep
    [T*K] pos < C, aux scalar load-balance loss)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.moe_top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)          # [T, E]
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)          # [T, K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)               # renormalise

    # position of each (token, k) assignment within its expert, GShard cumsum
    flat_e = gate_idx.reshape(-1)                                # [T*K]
    onehot = (flat_e[:, None] == torch.arange(E, device=xt.device)).to(
        torch.int32)                                             # [T*K, E]
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) - 1).gather(
        1, flat_e[:, None])[:, 0].long()

    # load-balance auxiliary loss (Switch/GShard form)
    ce = onehot.sum(0).float() / (T * K)                         # [E]
    aux = E * torch.sum(probs.mean(0) * ce)
    return gate_vals.reshape(-1), flat_e, pos, pos < C, aux


def moe_fwd(cfg, p, x, capacity=None):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar fp32).

    The reference's global scatter/gather program.  The K gated expert
    outputs of a token are summed with ``sum`` over K (in fp32 for a bf16
    model) where the reference scatter-adds them; the terms are the same."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    C = capacity or expert_capacity(T, cfg)
    xt = x.reshape(T, D)
    gates, flat_e, pos, keep, aux = route(cfg, p["router"], xt, C)

    # scatter tokens into per-expert buffers; an assignment at pos >= C
    # lands in the overflow row C, which the expert products do not read
    tok_idx = torch.arange(T * K, device=x.device) // K          # [T*K]
    buf = xt.new_zeros((E, C + 1, D)).index_put(
        (flat_e, torch.where(keep, pos, C)), xt[tok_idx],
        accumulate=True)[:, :C]

    # expert SwiGLU: [E, C, D] x [E, D, F]
    h = F.silu(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    h = torch.bmm(h, p["w2"])                                    # [E, C, D]

    # gather back with gate weights; dropped assignments contribute zero
    got = h[flat_e, torch.clamp(pos, max=C - 1)]                 # [T*K, D]
    got = got * (gates * keep).to(got.dtype)[:, None]
    out = got.reshape(T, K, D).sum(1, dtype=torch.float32).to(x.dtype)

    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + (F.silu(xt @ sp["w1"]) * (xt @ sp["w3"])) @ sp["w2"]
    return out.reshape(B, S, D), aux
