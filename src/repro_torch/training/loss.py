"""Loss functions: next-token cross-entropy for LM training and the paper's
parity-distillation MSE (§3.3 / §4.1 — MSE keeps ParM task-agnostic)."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def _gold(logits, labels):
    """logits[..., labels]: a gather, or, on a DTensor, the one logit where
    the label equals vocabulary ids placed like the logits' last dim (the
    same value and gradient; DTensor's gather along a sharded vocab dim
    fails to reduce its result in torch 2.13)."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    last = logits.ndim - 1
    ids = torch.arange(logits.shape[-1], device=logits.device)
    ids = DTensor.from_local(ids, logits.device_mesh, [Replicate()] * len(
        logits.placements)).redistribute(placements=[
            Shard(0) if pl == Shard(last) else Replicate()
            for pl in logits.placements])
    return torch.where(labels[..., None] == ids, logits, 0.0).sum(-1)


def softmax_xent(logits, labels, mask=None):
    """logits [..., V] float32; labels [...] int. Mean over valid tokens."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels)
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def lm_loss(logits, tokens, aux=0.0, aux_coef=0.01):
    """Shifted next-token loss; ``aux`` is the MoE load-balance term."""
    return (softmax_xent(logits[:, :-1], tokens[:, 1:])
            + aux_coef * aux)


def parity_mse(parity_out, target_sum):
    """Paper §4.1: MSE between the parity model's output and the desired
    linear combination of deployed-model outputs."""
    d = parity_out.float() - target_sum.float()
    return torch.mean(d * d)
