"""Quickstart: the ParM pipeline on the port (twin of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Train a small deployed classifier.
2. Learn a parity model for k=2 (paper §3.3).
3. Simulate an unavailable prediction and reconstruct it with the
   subtraction decoder (paper §3.2).

The group's tensors live on ``--device``: on the card the scheme's encode
launches B1 (``parity_encode``) and ``decode_one`` launches B3
(``parity_decode``); on the CPU their plain versions run.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.convert import resolve_device, tree_leaves
from repro_torch.core.metrics import topk_accuracy
from repro_torch.core.parity import train_parity_models
from repro_torch.data.pipeline import batched, cluster_images
from repro_torch.models.cnn import build
from repro_torch.training.loss import softmax_xent
from repro_torch.training.optim import AdamConfig, adam_init, adam_update

IMG = (16, 16, 1)


def train_classifier(x, y, device, image_shape=IMG):
    """The reference examples' deployed model: the MLP from seed 0, three
    epochs of Adam (lr 1e-3) on softmax cross-entropy over batches of 64.
    Returns (params, fwd), the parameters no longer requiring grad."""
    params, fwd = build("mlp", 0, image_shape=image_shape, device=device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    opt = AdamConfig(lr=1e-3)
    state = adam_init(params, opt)
    for xb, yb in batched(x, y, 64, epochs=3):
        loss = softmax_xent(fwd(params, xb), yb)
        adam_update(list(torch.autograd.grad(loss, leaves)), state, leaves,
                    opt)
    for p in leaves:
        p.requires_grad_(False)
    return params, fwd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. deployed model ----------------------------------------------------
    x, y, tmpl = cluster_images(3000, noise=2.0, seed=0, image_shape=IMG)
    xt, yt, _ = cluster_images(500, noise=2.0, seed=1, templates=tmpl,
                               image_shape=IMG)
    params, fwd = train_classifier(x, y, dev)
    with torch.no_grad():
        acc = topk_accuracy(fwd(params, xt), yt)
    print(f"deployed model accuracy A_a = {acc:.3f}")

    # 2. parity model (k=2, the "sum" scheme from the registry) ------------
    k = 2
    parity_params, scheme = train_parity_models(
        params, fwd, lambda s: build("mlp", s, image_shape=IMG,
                                     device=dev)[0],
        x, k=k, scheme="sum", epochs=5, device=dev)

    # 3. one coding group: X1, X2 -> P; X2's prediction is "unavailable" ---
    x1, x2 = (torch.as_tensor(xt[i:i + 1], device=dev) for i in (0, 1))
    with torch.no_grad():
        parity_query = scheme.encode(torch.stack([x1, x2]))[0]
        f_x1 = fwd(params, x1)
        f_p = fwd(parity_params[0], parity_query)
        recon = scheme.decode_one(f_p[0], torch.stack([f_x1[0],
                                                       f_x1[0] * 0]), 1)
        truth = fwd(params, x2)[0]
    out = {"A_a": acc, "true_class": int(truth.argmax()),
           "label": int(yt[1]), "reconstructed_class": int(recon.argmax()),
           "l2_gap": float(torch.linalg.norm(recon - truth))}
    print(f"true class of X2:           {out['true_class']} "
          f"(label {out['label']})")
    print(f"reconstructed prediction:   {out['reconstructed_class']}")
    print(f"reconstruction L2 gap:      {out['l2_gap']:.3f}")
    return out


if __name__ == "__main__":
    main()
