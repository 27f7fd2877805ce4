"""Accuracy metrics of the paper (§4.1): available accuracy A_a, degraded-mode
accuracy A_d (every one-of-k-unavailable scenario simulated, as the paper's
evaluation does), and overall accuracy A_o(f_u) = (1-f_u) A_a + f_u A_d."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import to_host


def topk_accuracy(logits, labels, k=1):
    logits = to_host(logits)
    if k == 1:
        return float((np.argmax(logits, -1) == labels).mean())
    topk = np.argsort(logits, -1)[:, -k:]
    return float((topk == labels[:, None]).any(-1).mean())


def degraded_accuracy(parity_outs, member_outs, labels, decoder, topk=1):
    """Simulate each one-unavailable scenario per coding group.

    parity_outs [G, r, V]; member_outs [G, k, V]; labels [G, k].
    Returns A_d — accuracy of reconstructed predictions only.  Every group
    of position j decodes in ONE ``decoder.decode_one_many`` call (the
    multigroup kernel under the kernels backend); a decoder without the
    batched surface decodes group by group."""
    G, k, V = member_outs.shape
    many = getattr(decoder, "decode_one_many", None)
    hits, total = 0, 0
    for j in range(k):
        if many is not None:
            recon = many(parity_outs[:, 0], member_outs, np.full(G, j))
        else:
            recon = torch.stack([torch.as_tensor(decoder.decode_one(
                parity_outs[g, 0], member_outs[g], j)) for g in range(G)])
        hits += _topk_hits(to_host(recon), labels[:, j], topk)
        total += G
    return hits / total


def _topk_hits(logits, labels, k):
    if k == 1:
        return int((np.argmax(logits, -1) == labels).sum())
    topk = np.argsort(logits, -1)[:, -k:]
    return int((topk == labels[:, None]).any(-1).sum())


def overall_accuracy(a_a, a_d, f_u):
    """Paper Eq. (1)."""
    return (1.0 - f_u) * a_a + f_u * a_d


def default_prediction_accuracy(n_classes):
    """Clipper's baseline: return a default prediction when the SLO is
    violated — no better than a random/constant guess."""
    return 1.0 / n_classes


def iou(box_a, box_b):
    """Intersection-over-union for the object-localization task (§4.2.1).
    Boxes [..., 4] as (x0, y0, x1, y1)."""
    ax0, ay0, ax1, ay1 = np.moveaxis(box_a, -1, 0)
    bx0, by0, bx1, by1 = np.moveaxis(box_b, -1, 0)
    ix = np.maximum(0, np.minimum(ax1, bx1) - np.maximum(ax0, bx0))
    iy = np.maximum(0, np.minimum(ay1, by1) - np.maximum(ay0, by0))
    inter = ix * iy
    area_a = np.maximum(0, ax1 - ax0) * np.maximum(0, ay1 - ay0)
    area_b = np.maximum(0, bx1 - bx0) * np.maximum(0, by1 - by0)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)
