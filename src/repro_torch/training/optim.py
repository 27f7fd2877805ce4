"""Optimizers from scratch, matching ``repro.training.optim`` step for step.

Adam/AdamW with a configurable moment dtype, decoupled weight decay and a
global-norm gradient clip.  State and parameters are trees of tensors (nested
dicts/lists).  The update runs under ``torch.no_grad`` and writes the new
values into the parameter and moment tensors in place (no second copy of the
parameters), then returns them, so call sites read like the JAX package's
functional ``params, state = adam_update(grads, state, params, cfg)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.convert import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0            # AdamW when > 0
    moment_dtype: str = "float32"
    grad_clip: float = 0.0               # global-norm clip; 0 = off


def _dtype(name):
    return getattr(torch, name)


def adam_init(params, cfg: AdamConfig):
    dt = _dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adam_update(grads, state, params, cfg: AdamConfig):
    """One Adam step: bias-corrected moments, decoupled ``weight_decay``,
    optional global-norm ``grad_clip``; fp32 arithmetic, moments stored in
    ``cfg.moment_dtype``.  Updates ``params`` and the moments in place and
    returns ``(params, state)``."""
    step = state["step"] + 1
    g_flat = tree_leaves(grads)
    if cfg.grad_clip:
        gn = global_norm(g_flat)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
        g_flat = [g * scale for g in g_flat]
    dt = _dtype(cfg.moment_dtype)
    # fp32 bias corrections, as the reference computes them from an int32
    # step under JAX's default 32-bit floats
    p_flat = tree_leaves(params)
    dev = p_flat[0].device if p_flat else None
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=dev) ** step
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=dev) ** step
    for g, m, v, p in zip(g_flat, tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), p_flat):
        g32 = g.float()
        m32 = m.float() * cfg.b1 + g32 * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + g32 * g32 * (1 - cfg.b2)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - cfg.lr * delta).to(p.dtype))
        m.copy_(m32.to(dt))
        v.copy_(v32.to(dt))
    state["step"] = step
    return params, state


@torch.no_grad()
def sgd_update(grads, params, lr):
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        p.sub_(lr * g)
    return params
