"""Mamba2 (SSD — state-space duality) mixer layer: the JAX package's
``models/mamba.py``.

Prefill uses the chunked SSD algorithm [arXiv:2405.21060]: the sequence is
split into chunks of length Q; within-chunk interactions are a masked
quadratic form, and chunk-to-chunk interaction flows through a small
recurrent state carried by a Python loop over the chunks (the reference's
``lax.scan``) — O(L·Q) instead of O(L^2).  Decode is the pure recurrence
``h' = a·h + Δx ⊗ B;  y = C·h' + D·x`` with O(1) state.  The state and the
decays are fp32 whatever the model dtype.

The intra-chunk decay ``exp(cum_i - cum_j)`` is computed for every (i, j)
and masked afterwards, as the reference does.  For i < j it can overflow to
inf at the full chunk of 256, which leaves the forward unchanged but makes
the masked branch's gradient 0 * inf: the gradients are finite at the
reduced chunk only (``ROADMAP.md`` §C).

The reference's logical sharding constraints are kept (the identity without
launcher rules); a head split of a width is constrained before the reshape,
as in ``models/layers.py``.  On DTensors the chunked scan and the decode
recurrence run on each rank's shard of the batch and the heads
(``_local_batch_heads``), where the reference constrains the scan's
carries.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import logical
from repro_torch.distributed.logical import constrain
from repro_torch.models.layers import _dense, make_norm, pad_seq, \
    rms_norm, torch_dtype


def _dims(cfg):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = cfg.ssm_groups
    conv_dim = di + 2 * G * N
    return di, H, P, N, G, conv_dim


def _heads(t, rep):
    """[..., G, N] -> [..., G * rep, N]: each group's row repeated for the
    rep heads it serves (the reference's ``jnp.repeat``; a view and a copy,
    no host round trip)."""
    *lead, G, N = t.shape
    return t[..., None, :].expand(*lead, G, rep, N).reshape(*lead, G * rep,
                                                             N)


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def init_mamba(cfg, gen, *, device="cpu", lead=()):
    D = cfg.d_model
    di, H, P, N, G, conv_dim = _dims(cfg)
    dt = torch_dtype(cfg)
    lead = tuple(lead)
    d_in_proj = 2 * di + 2 * G * N + H
    # dt bias: inverse softplus of dt ~ U[1e-3, 1e-1] (log-uniform)
    dt0 = torch.exp(_uniform(gen, lead + (H,), math.log(1e-3),
                             math.log(1e-1), device))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "in_proj": _dense(gen, (D, d_in_proj), dt, device, lead),
        "conv_w": _dense(gen, (cfg.ssm_conv, conv_dim), dt, device, lead),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(_uniform(gen, lead + (H,), 1.0, 16.0, device)),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias.float(),
        "gate_norm": torch.ones(lead + (di,), dtype=dt, device=device),
        "out_proj": _dense(gen, (di, D), dt, device, lead),
        "norm": make_norm(cfg, D, device=device, lead=lead),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x [B, L, C]; w [W, C]."""
    W, L = w.shape[0], x.shape[1]
    xp = pad_seq(x, W - 1, 0)
    y = sum(xp[:, i:i + L, :] * w[i] for i in range(W))
    return F.silu(y + b)


def _split_in(cfg, p, x):
    di, H, P, N, G, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [di, conv_dim, H], dim=-1)
    return z, xBC, dt


def _chunked_scan(Q, dx, Bh, Ch, loga, h=None):
    """The chunked SSD on [B, L, H, ...] tensors (L a multiple of Q): the
    masked quadratic form within each chunk of Q steps and the state
    carried from chunk to chunk.  ``h`` is the initial state [B, H, N, P]
    (zeros when None).  Returns (y [B, L, H, P], final state)."""
    B, L, H, P = dx.shape
    N = Bh.shape[-1]
    nc = L // Q
    # chunk views [B, nc, Q, ...]
    dxc = dx.reshape(B, nc, Q, H, P)
    Bh = Bh.reshape(B, nc, Q, H, N)
    Ch = Ch.reshape(B, nc, Q, H, N)
    cum = torch.cumsum(loga.reshape(B, nc, Q, H), dim=2)         # [B,nc,Q,H]

    # ---- intra-chunk (quadratic, parallel over chunks) ----
    # scores[b,c,h,i,j] = (C_i . B_j) * exp(cum_i - cum_j), i >= j
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    dec = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    dec = dec.permute(0, 1, 4, 2, 3)                             # [B,nc,H,i,j]
    ii = torch.arange(Q, device=dx.device)
    mask = ii[:, None] >= ii[None, :]
    scores = torch.where(mask, cb * dec, 0.0)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, dxc)

    # ---- chunk state + inter-chunk recurrence ----
    seg = torch.exp(cum[:, :, -1:, :] - cum)                     # exp(cum_Q - cum_j)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bh, seg, dxc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # [B,nc,H]

    if h is None:
        h = torch.zeros((B, H, N, P), dtype=torch.float32, device=dx.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                        # [B,nc,H,N,P]

    inter_dec = torch.exp(cum)                                   # [B,nc,Q,H]
    y_inter = torch.einsum("bcihn,bcih,bchnp->bcihp", Ch, inter_dec, h_prevs)
    return (y_intra + y_inter).reshape(B, L, H, P), h


def ssd_fwd(cfg, p, x, *, init_state=None, return_state=False):
    """Full-sequence SSD. x [B, L, D] -> (y [B, L, D], state|None).

    ``init_state``/``return_state`` support prefill -> decode handoff: the
    state is {"ssm": [B, H, N, P] fp32, "conv": [B, W-1, conv_dim]}."""
    B, L0, D = x.shape
    di, H, P, N, G, conv_dim = _dims(cfg)
    Q = min(cfg.ssm_chunk, L0)
    pad = (-L0) % Q
    if pad:
        x = pad_seq(x, 0, pad)
    L = L0 + pad

    z, xBC, dt = _split_in(cfg, p, x)
    if pad:
        # make padded steps identity: delta -> 0 => a=1, dx=0
        step_mask = torch.arange(L, device=x.device) < L0
        dt = dt.masked_fill(~step_mask[None, :, None], -1e9)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = constrain(xs, ("batch", None, "heads"), shape=(B, L, H))
    xs = constrain(xs.reshape(B, L, H, P), ("batch", None, "heads", None))
    Bm = constrain(Bm, ("batch", None, None))
    Cm = constrain(Cm, ("batch", None, None))

    delta = F.softplus(dt.float() + p["dt_bias"])                # [B,L,H]
    loga = constrain(-torch.exp(p["A_log"]) * delta,
                     ("batch", None, "heads"))                   # [B,L,H]
    dx = xs.float() * delta[..., None]                           # Δ·x

    rep = H // G
    # B and C repeated over the heads of a group: [B, L, H, N]
    Bh = _heads(Bm.float().reshape(B, L, G, N), rep)
    Ch = _heads(Cm.float().reshape(B, L, G, N), rep)
    args = (dx, Bh, Ch, loga) if init_state is None else \
        (dx, Bh, Ch, loga, init_state.float())
    y, h = _local_batch_heads(functools.partial(_chunked_scan, Q), args,
                              (2, 2, 2, 2, 1)[:len(args)], (2, 1))
    y = constrain(y + p["D"][None, None, :, None] * xs.float(),
                  ("batch", None, "heads", None))
    y = y.reshape(B, L, di)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["gate_norm"])
    out = (y @ p["out_proj"])[:, :L0]
    if return_state:
        conv_tail = xBC_tail(cfg, x[:, :L0], p)
        return out, {"ssm": h.float(), "conv": conv_tail}
    return out, None


def xBC_tail(cfg, x, p):
    """Last (conv_width - 1) pre-conv xBC rows, for decode handoff."""
    _, xBC, _ = _split_in(cfg, p, x)
    return xBC[:, -(cfg.ssm_conv - 1):, :]


def init_ssm_cache(cfg, batch, *, device="cpu", lead=()):
    di, H, P, N, G, conv_dim = _dims(cfg)
    lead = tuple(lead)
    return {"ssm": torch.zeros(lead + (batch, H, N, P), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=torch_dtype(cfg), device=device)}


def _recurrence(state, a, Bh, dx, Ch):
    """h' = a·h + Δx ⊗ B and y = C·h', per (batch row, head)."""
    h = state * a[..., None, None] + torch.einsum("bhn,bhp->bhnp", Bh, dx)
    return h, torch.einsum("bhn,bhnp->bhp", Ch, h)


def _local_batch_heads(fn, args, heads_at, out_heads_at):
    """``fn(*args)`` -> two outputs, on each rank's local shard of the
    batch (dim 0 of every tensor) and the heads (dim ``heads_at[i]`` of
    ``args[i]``, ``out_heads_at[j]`` of output j) when the first arg is a
    DTensor under launcher rules: the SSD is independent per (batch row,
    head), and torch 2.11 refuses the batched products of an ``einsum``
    that would flatten two sharded dimensions.  Which mesh axes shard the
    batch and the heads is the reference's spec arithmetic."""
    x = args[0]
    if logical.state()[0] is None or not isinstance(x, DTensor):
        return fn(*args)
    spec = logical.logical_spec((x.shape[0], x.shape[heads_at[0]]),
                                ("batch", "heads"))

    def pl(d):                 # placements with the heads at tensor dim d
        return logical.placements(
            (spec[0],) + (None,) * (d - 1) + (spec[1],), x.device_mesh)
    return local_map(fn, out_placements=tuple(pl(d) for d in out_heads_at),
                     in_placements=tuple(pl(d) for d in heads_at),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(*args)


def ssd_decode(cfg, p, x, cache):
    """One-step recurrence. x [B, 1, D] -> (y [B, 1, D], new cache); the
    new state and conv tail are new tensors (``cache`` is only read)."""
    B = x.shape[0]
    di, H, P, N, G, conv_dim = _dims(cfg)
    z, xBC, dt = _split_in(cfg, p, x)                            # [B,1,*]
    # conv over (cached tail ++ current)
    win = torch.cat([cache["conv"], xBC], dim=1)                 # [B,W,C]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"])
                      + p["conv_b"])
    new_conv = win[:, 1:, :]

    xs, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    xs = constrain(xs, ("batch", "heads"), shape=(B, H))
    xs = xs.reshape(B, H, P).float()
    Bm = constrain(Bm, ("batch", None))
    Cm = constrain(Cm, ("batch", None))
    rep = H // G
    Bh = _heads(Bm.reshape(B, G, N).float(), rep)
    Ch = _heads(Cm.reshape(B, G, N).float(), rep)

    delta = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"]) * delta)                # [B,H]
    dx = xs * delta[..., None]                                   # [B,H,P]
    h, y = _local_batch_heads(_recurrence, (cache["ssm"], a, Bh, dx, Ch),
                              (1,) * 5, (1, 1))
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, di)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["gate_norm"])
    return y @ p["out_proj"], {"ssm": h, "conv": new_conv}
