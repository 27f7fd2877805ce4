"""Accuracy under unavailability, across coding schemes (paper §4's A_a /
A_d methodology applied to the scheme registry).

One shared pipeline — train a deployed model on the resnet18_cifar task
family, then for each scheme provision its parity/backup models through
``train_parity_models`` and measure

* ``A_a`` — available accuracy (deployed model, no unavailability), and
* ``A_d`` — degraded accuracy: with ONE unavailable query per coding group,
  the accuracy of the scheme's *reconstructed* predictions only.

Every scheme flows through the registry entry points the serving layers
use: ``sum`` / ``concat`` (parity models distilled per §3.3), ``learned``
(joint encoder+parity training), ``approx_backup`` (k=1 groups, a cheaper
backup architecture distilled from the deployed model), ``approxifer`` and
``invnet`` (no parity training: the deployed model serves the encoded
queries) and ``fisher`` (Fisher-merged parity models, zero gradient steps).

``accuracy_under_errors`` extends the methodology to the Byzantine fault
class: all responses arrive, but a fraction of the member responses is
*erroneous* (garbage at ``CORRUPTION_SCALE``).  A ``detects_errors``
scheme (approxifer) votes the corrupted responses out using its surplus
parity responses and re-decodes them; schemes without detection serve the
garbage.

Training and inference run on ``device`` (``"cuda"`` unless the caller asks
for ``"cpu"``); the data is made on the host with numpy from ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.resnet18_cifar import IMAGE_SHAPE
from repro_torch.convert import to_host, tree_leaves, tree_map
from repro_torch.core.metrics import degraded_accuracy, topk_accuracy
from repro_torch.core.parity import fused_parity_outputs, train_parity_models
from repro_torch.core.scheme import scheme_capabilities
from repro_torch.data.pipeline import batched, cluster_images
from repro_torch.models.cnn import build
from repro_torch.training.loss import softmax_xent
from repro_torch.training.optim import AdamConfig, adam_init, adam_update

DEFAULT_SCHEMES = ("sum", "concat", "learned", "approx_backup",
                   "approxifer", "fisher", "invnet")


def _train_deployed(x, y, model, image_shape, n_classes, epochs, seed,
                    device):
    params, fwd = build(model, seed, image_shape=image_shape, n_out=n_classes,
                        device=device)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    leaves = tree_leaves(params)
    opt = AdamConfig(lr=1e-3)
    state = adam_init(params, opt)
    for xb, yb in batched(x, y, 64, seed=seed, epochs=epochs):
        loss = softmax_xent(fwd(params, xb), yb)
        grads = torch.autograd.grad(loss, leaves)
        adam_update(list(grads), state, leaves, opt)
    return tree_map(lambda p: p.detach(), params), fwd


def _task(n_train, n_test, noise, seed, image_shape, n_classes):
    x, y, tmpl = cluster_images(n_train, noise=noise, seed=seed,
                                image_shape=image_shape, n_classes=n_classes)
    xt, yt, _ = cluster_images(n_test, noise=noise, seed=seed + 1,
                               templates=tmpl, image_shape=image_shape,
                               n_classes=n_classes)
    return x, y, xt, yt


def _outputs(scheme, parity_params, parity_fwd, deployed_params, fwd, xt,
             n_classes):
    """Member outputs [G, k, V] and parity outputs [G, r, V] (device
    tensors) for the test set grouped by ``scheme.k``."""
    gk = scheme.k
    n = (len(xt) // gk) * gk
    groups = xt[:n].reshape(-1, gk, *xt.shape[1:])              # [G, gk, ...]
    with torch.inference_mode():
        member = fwd(deployed_params, groups.reshape(n, *xt.shape[1:]))
        # the fused coded hot path for linear/MLP substrates, the exact
        # encode + per-row forward fallback for everything else
        pouts = fused_parity_outputs(scheme, np.moveaxis(groups, 1, 0),
                                     parity_params, parity_fwd)  # [r, G, V]
    return member.reshape(-1, gk, n_classes), pouts.transpose(0, 1)


def _degraded(scheme, parity_params, parity_fwd, deployed_params, fwd,
              xt, yt, n_classes):
    """A_d with one unavailable member per group, every position simulated
    (the paper's evaluation loop), via the scheme's own encode/decode."""
    member, parity_outs = _outputs(scheme, parity_params, parity_fwd,
                                   deployed_params, fwd, xt, n_classes)
    glabels = yt[:member.shape[0] * scheme.k].reshape(-1, scheme.k)
    with torch.inference_mode():
        return degraded_accuracy(parity_outs, member, glabels, scheme)


def accuracy_under_unavailability(schemes=DEFAULT_SCHEMES, *, model="resnet",
                                  backup_model="mlp",
                                  image_shape=IMAGE_SHAPE, n_classes=10,
                                  k=2, n_train=1500, n_test=600, noise=2.0,
                                  deployed_epochs=3, parity_epochs=5,
                                  seed=0, device="cuda", provisioned=None):
    """Returns ``{"A_a": float, "schemes": {name: A_d}}`` on the
    resnet18_cifar task family (CIFAR-shaped Gaussian-cluster images).

    ``provisioned``, when a dict, receives what was built so a caller can
    score it again: ``"deployed"`` -> ``(params, fwd)``, ``"test"`` ->
    ``(xt, yt)`` and each scheme's name -> ``(scheme, parity_params,
    parity_fwd)``."""
    x, y, xt, yt = _task(n_train, n_test, noise, seed, image_shape,
                         n_classes)
    params, fwd = _train_deployed(x, y, model, image_shape, n_classes,
                                  deployed_epochs, seed, device)
    with torch.inference_mode():
        a_a = topk_accuracy(fwd(params, xt), yt)
    if provisioned is not None:
        provisioned.update(deployed=(params, fwd), test=(xt, yt))

    results = {}
    for name in schemes:
        if name == "approx_backup":
            # the backup is a cheaper architecture; the k=1 "parity
            # training" is plain distillation of the deployed model into it
            def init_fn(s):
                return build(backup_model, s, image_shape=image_shape,
                             n_out=n_classes, device=device)[0]
            pfwd = build(backup_model, 0, image_shape=image_shape,
                         n_out=n_classes, device=device)[1]
        else:
            # parity models share the deployed architecture (§3.3)
            def init_fn(s):
                return build(model, s, image_shape=image_shape,
                             n_out=n_classes, device=device)[0]
            pfwd = fwd
        pp, scheme = train_parity_models(
            params, fwd, init_fn, x, k=k, scheme=name, epochs=parity_epochs,
            seed=seed, parity_fwd=pfwd, device=device)
        results[name] = _degraded(scheme, pp, pfwd, params, fwd, xt, yt,
                                  n_classes)
        if provisioned is not None:
            provisioned[name] = (scheme, pp, pfwd)
    return {"A_a": a_a, "schemes": results}


def _served_under_errors(scheme, member, parity_outs, corrupt):
    """Predictions actually served for one error realization.

    member [G, k, V] true member outputs; parity_outs [G, r, V] (host
    numpy); ``corrupt`` [G, k] marks erroneous member responses (replaced by
    garbage at CORRUPTION_SCALE).  A ``detects_errors`` scheme votes the
    garbage out per group and re-decodes the flagged members from the clean
    remainder; every other scheme serves the garbage as-is."""
    from repro_torch.serving.scenarios import CORRUPTION_SCALE
    k = member.shape[1]
    served = member.copy()
    served[corrupt] = CORRUPTION_SCALE
    if not scheme_capabilities(scheme).detects_errors:
        return served
    ones_m = np.ones(k, bool)
    ones_p = np.ones(scheme.r, bool)
    for g in np.nonzero(corrupt.any(axis=1))[0]:
        mflags, pflags = scheme.flag_errors(served[g], ones_m,
                                            parity_outs[g], ones_p)
        if not mflags.any():
            continue                      # below the voting margin: served
        recon = to_host(scheme.decode(parity_outs[g] * ~pflags[:, None],
                                      served[g], mflags, ~pflags))
        served[g][mflags] = recon[mflags]
    return served


def accuracy_under_errors(schemes=("sum", "learned", "approxifer", "fisher",
                                   "invnet"), *,
                          error_rates=(0.0, 0.1, 0.25), model="resnet",
                          image_shape=IMAGE_SHAPE, n_classes=10, k=2, r=2,
                          n_train=1500, n_test=600, noise=2.0,
                          deployed_epochs=3, parity_epochs=5, seed=0,
                          device="cuda"):
    """Accuracy when member responses are *erroneous* (Byzantine), swept
    over the per-response error rate.  All responses arrive; each member
    response is independently corrupted with probability ``rate``.  ``r``
    extra responses per group give a ``detects_errors`` scheme the surplus
    it needs to vote garbage out (r >= 2 corrects one error per group).

    Returns ``{"A_a": float, "schemes": {name: {rate: accuracy}}}`` —
    accuracy of the predictions actually served, over all members."""
    x, y, xt, yt = _task(n_train, n_test, noise, seed, image_shape,
                         n_classes)
    params, fwd = _train_deployed(x, y, model, image_shape, n_classes,
                                  deployed_epochs, seed, device)
    with torch.inference_mode():
        a_a = topk_accuracy(fwd(params, xt), yt)

    def init_fn(s):
        return build(model, s, image_shape=image_shape, n_out=n_classes,
                     device=device)[0]

    results = {}
    for name in schemes:
        pp, scheme = train_parity_models(
            params, fwd, init_fn, x, k=k, r=r, scheme=name,
            epochs=parity_epochs, seed=seed, device=device)
        member, parity_outs = _outputs(scheme, pp, fwd, params, fwd, xt,
                                       n_classes)
        member, parity_outs = to_host(member), to_host(parity_outs)
        glabels = yt[:member.shape[0] * scheme.k].reshape(-1, scheme.k)
        per_rate = {}
        for rate in error_rates:
            rng = np.random.default_rng(seed + int(rate * 1000))
            corrupt = rng.random(member.shape[:2]) < rate
            served = _served_under_errors(scheme, member, parity_outs,
                                          corrupt)
            per_rate[rate] = float(
                (np.argmax(served, -1) == glabels).mean())
        results[name] = per_rate
    return {"A_a": a_a, "schemes": results}
