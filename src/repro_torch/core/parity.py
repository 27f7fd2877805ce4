"""Parity models (paper §3.3): construction, training-data generation and the
distillation training loop.

A parity model F_P shares the deployed model's architecture (same average
runtime => parity instances keep pace at 1/k the query rate, §5.2.6) but is
trained on parity queries with targets that are the code's linear combination
of deployed-model outputs:

    F_P( E(X_1..X_k) )  ~=  sum_i C[j,i] * F(X_i)      (one model per parity j)

Training data is generated from the deployed model's own training set;
labels come from deployed-model inference (distillation) or, when labelled
data exists, from summed one-hot labels.  Datasets are built on the host in
numpy (bit-equal to the JAX package's); training and inference run on the
device the parameters live on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.convert import as_tensor, to_host, tree_leaves, tree_map
from repro_torch.core.scheme import (LinearScheme, ReplicationScheme,
                                     get_scheme, scheme_capabilities)
from repro_torch.training.loss import parity_mse
from repro_torch.training.optim import AdamConfig, adam_init, adam_update

# schemes whose (un-overridden) encode is exactly the coeffs product, so the
# per-row training set can be built with one einsum instead of a full encode
_ROW_SEPARABLE_ENCODES = (LinearScheme.encode, ReplicationScheme.encode)

# test hook for the fused encode->forward serving path below: None = fuse
# whenever the (scheme, parity model) pair is eligible, False = always take
# the exact unfused fallback, True = require fusion (raise if ineligible)
_FORCE_FUSED = None


def _first_layer_split(parity_params, parity_fwd):
    """Detect the linear/MLP parity substrate fusion applies to.

    Fusion is sound only when the parity forward is the canonical
    reshape-then-matmul chain, so the check is exact: ``parity_fwd`` must BE
    ``models.linear.linear_fwd`` (params ``{"w": [F, V]}``, tail = identity)
    or ``models.cnn.mlp_fwd`` (params ``{"w": [...], "b": [...]}``, tail =
    bias + relu + the remaining layers), and every parity row's first-layer
    matrix must share one shape.  Returns ``(stacked first-layer weights
    [r, F, V], per-row tail fns)`` or ``None`` (caller falls back to the
    unfused encode + per-row forward)."""
    from repro_torch.models.cnn import mlp_fwd
    from repro_torch.models.linear import linear_fwd

    def one(p):
        if parity_fwd is linear_fwd and isinstance(p, dict) and \
                set(p) == {"w"} and getattr(p["w"], "ndim", 0) == 2:
            return p["w"], None
        if parity_fwd is mlp_fwd and isinstance(p, dict) and \
                set(p) == {"w", "b"} and isinstance(p["w"], (list, tuple)):
            def tail(h, p=p):
                h = h + p["b"][0]
                for i in range(1, len(p["w"])):
                    h = torch.relu(h) @ p["w"][i] + p["b"][i]
                return h
            return p["w"][0], tail
        return None
    splits = [one(p) for p in parity_params]
    if any(s is None for s in splits) or \
            len({tuple(s[0].shape) for s in splits}) != 1:
        return None
    return torch.stack([s[0] for s in splits]), [s[1] for s in splits]


def fused_parity_outputs(scheme, queries, parity_params, parity_fwd):
    """Serve all r parity rows for stacked coding groups: queries
    [k, B, ...] -> parity outputs [r, B, V].

    When ``scheme``'s encode is the un-overridden linear coeffs product and
    every parity model is a linear/MLP substrate (see
    ``_first_layer_split``), encode and the first forward matmul run fused —
    one ``kernels/fused_encode_forward.py`` launch under
    ``backend="kernels"`` — and only the per-row MLP tail (bias/relu/rest)
    runs separately.  Any other (scheme, model) pair takes the exact unfused
    fallback, ``scheme.encode`` + per-row ``parity_fwd``."""
    queries = as_tensor(queries, torch.device(scheme.device))
    fusable = type(scheme).encode is LinearScheme.encode and \
        isinstance(scheme, LinearScheme) and _FORCE_FUSED is not False
    split = _first_layer_split(parity_params, parity_fwd) if fusable \
        else None
    if split is not None and \
            split[0].shape[1] == int(np.prod(queries.shape[2:])):
        weights, tails = split
        h = scheme.encode_forward(queries, weights)          # [r, B, V1]
        return torch.stack([h[j] if tails[j] is None else tails[j](h[j])
                            for j in range(scheme.r)])
    if _FORCE_FUSED is True:
        raise ValueError(
            "fused parity serving forced (_FORCE_FUSED=True) but the "
            "(scheme, parity model) pair is not fusable")
    enc = scheme.encode(queries)
    return torch.stack([parity_fwd(parity_params[j], enc[j])
                        for j in range(scheme.r)])


def group_queries(x, k, rng):
    """Randomly group n samples into floor(n/k) coding groups: [G, k, ...]."""
    n = (len(x) // k) * k
    order = rng.permutation(len(x))[:n]
    return x[order].reshape(len(x) // k, k, *x.shape[1:]), order[:n]


def make_parity_dataset(x, fx, k, scheme, j, rng):
    """Training set for the j-th parity model: parity queries are the
    scheme's j-th encoded row, targets the j-th coefficient-row combination
    of deployed outputs.

    x: queries [n, ...]; fx: deployed outputs F(x) [n, V] (host numpy).
    Returns host numpy (parity queries [G, ...], targets [G, ...])."""
    groups, order = group_queries(x, k, rng)
    fx_groups = fx[order].reshape(groups.shape[0], k, *fx.shape[1:])
    coeff_row = scheme.host_coeffs[j]
    if type(scheme).encode in _ROW_SEPARABLE_ENCODES:
        # un-overridden linear encode: compute only row j instead of encoding
        # all r rows over the full training set and keeping one
        parities = np.einsum("k,gk...->g...", coeff_row, groups)
    else:
        # custom encoders (concat): the parity model must train on exactly
        # what the frontend will feed it — [k, G, ...] -> [r, G, ...]
        parities = to_host(scheme.encode(np.moveaxis(groups, 1, 0)))[j]
    targets = np.einsum("k,gk...->g...", coeff_row, fx_groups)
    return np.asarray(parities, np.float32), np.asarray(targets, np.float32)


@dataclass
class ParityTrainer:
    """Trains one parity model with MSE distillation (Adam, paper §4.1
    hyperparameters: lr=1e-3, L2=1e-5, minibatch 32-64).  Each step is one
    autograd pass and one in-place Adam update on the device the parameters
    live on; the caller's parameter tree is left untouched (training runs on
    a copy)."""
    fwd: callable                   # fwd(params, x) -> outputs
    opt: AdamConfig = AdamConfig(lr=1e-3, weight_decay=1e-5)

    def train(self, params, parities, targets, batch=64, epochs=5, seed=0,
              log_every=0):
        params = tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        leaves = tree_leaves(params)
        dev = leaves[0].device
        opt_state = adam_init(params, self.opt)
        rng = np.random.default_rng(seed)
        losses = []
        n = len(parities)
        for ep in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch + 1, batch):
                sel = order[i:i + batch]
                xb = as_tensor(parities[sel], dev)
                yb = as_tensor(targets[sel], dev)
                loss = parity_mse(self.fwd(params, xb), yb)
                grads = torch.autograd.grad(loss, leaves)
                adam_update(list(grads), opt_state, leaves, self.opt)
                losses.append(loss.item())
            if log_every:
                print(f"  parity epoch {ep}: loss={losses[-1]:.5f}")
        return params, losses


def _train_joint(scheme, parity_fwd, init_fn, x, fx, epochs, seed, batch,
                 opt=None, log_every=0):
    """Joint encoder + parity objective for trainable schemes:
    minimise  mean_j MSE( F_P_j( E_theta(X)_j ),  sum_i C[j,i] F(X_i) )
    over (theta, parity params) together.  The decode targets stay the
    linear ``coeffs`` combination, so the scheme's decode and
    recoverability semantics hold for the trained encoder.  Grouping and
    batch order come from ``np.random.default_rng(seed)`` exactly as in the
    reference; parity params start from ``init_fn(seed + 17 * j)``.  Each
    step is one autograd pass through ``scheme.encode_with_params`` (plain
    torch) and one in-place Adam update on the scheme's device.

    Returns ``(parity_params list, scheme.with_params(trained_theta),
    losses)``."""
    k, r = scheme.k, scheme.r
    rng = np.random.default_rng(seed)
    groups, order = group_queries(np.asarray(x), k, rng)        # [G, k, ...]
    fxg = fx[order].reshape(groups.shape[0], k, *fx.shape[1:])
    targets = np.einsum("rk,gk...->rg...", scheme.host_coeffs, fxg)
    qk = np.ascontiguousarray(np.moveaxis(groups, 1, 0))        # [k, G, ...]
    dev = torch.device(scheme.device)

    def fresh(t):
        return t.detach().clone().requires_grad_(True)
    params = {"enc": tree_map(fresh, scheme.enc_params),
              "parity": [tree_map(fresh, init_fn(seed + 17 * j))
                         for j in range(r)]}
    leaves = tree_leaves(params)
    opt = opt or AdamConfig(lr=1e-3, weight_decay=1e-5)
    state = adam_init(params, opt)
    n_groups = groups.shape[0]
    b = min(batch, n_groups)
    losses = []
    for ep in range(epochs):
        order = rng.permutation(n_groups)
        for i in range(0, n_groups - b + 1, b):
            sel = order[i:i + b]
            qb = as_tensor(qk[:, sel], dev)
            tb = as_tensor(targets[:, sel], dev)
            enc_q = scheme.encode_with_params(params["enc"], qb)
            loss = sum(parity_mse(parity_fwd(params["parity"][j], enc_q[j]),
                                  tb[j]) for j in range(r)) / r
            grads = torch.autograd.grad(loss, leaves)
            adam_update(list(grads), state, leaves, opt)
            losses.append(loss.item())
        if log_every:
            print(f"  joint encoder+parity epoch {ep}: "
                  f"loss={losses[-1]:.5f}")
    frozen = tree_map(lambda t: t.detach(), params)
    return frozen["parity"], scheme.with_params(frozen["enc"]), losses


@dataclass
class ParityTrainContext:
    """Everything a scheme's ``provision_parity`` hook may need: the
    deployed forward fn, a parity-model initialiser (``init_fn(seed)``),
    training data and the distillation hyperparameters.

    ``deployed_outputs(deployed_params)`` lazily computes (and caches) the
    distillation targets F(x_train) as host numpy — or the scaled one-hot
    labels when ``use_true_labels``."""

    fwd: Callable                        # fwd(params, x) -> outputs
    init_fn: Optional[Callable]          # init_fn(seed) -> parity params
    x_train: Any                         # [n, ...] queries
    epochs: int = 5
    seed: int = 0
    batch: int = 64
    use_true_labels: bool = False
    labels: Any = None
    n_classes: Optional[int] = None
    parity_fwd: Optional[Callable] = None   # defaults to fwd
    scheme: Any = None                   # published (possibly retrained)
    _fx: Any = field(default=None, repr=False)

    @property
    def pfwd(self):
        return self.parity_fwd or self.fwd

    def deployed_outputs(self, deployed_params):
        if self._fx is None:
            if self.use_true_labels:
                # scaled one-hot labels (paper §4.1's label-sum variant)
                self._fx = np.eye(self.n_classes,
                                  dtype=np.float32)[self.labels] * 10.0
            else:
                with torch.inference_mode():
                    self._fx = to_host(self.fwd(deployed_params,
                                                np.asarray(self.x_train)))
        return self._fx


def default_provision(scheme, deployed_params, ctx: ParityTrainContext):
    """The stock provisioning path schemes delegate to: per-row MSE
    distillation (paper §3.3), or the joint encoder+parity objective for
    ``trainable`` schemes (the trained scheme is published on
    ``ctx.scheme``).  ``model_agnostic`` schemes short-circuit to r
    references of the deployed params."""
    caps = scheme_capabilities(scheme)
    if caps.model_agnostic:
        return [deployed_params] * scheme.r
    fx = ctx.deployed_outputs(deployed_params)
    if caps.trainable:
        parity_params, trained, _ = _train_joint(
            scheme, ctx.pfwd, ctx.init_fn, ctx.x_train, fx,
            epochs=ctx.epochs, seed=ctx.seed, batch=ctx.batch)
        ctx.scheme = trained
        return parity_params
    rng = np.random.default_rng(ctx.seed)
    parity_params = []
    for j in range(scheme.r):
        pq, tg = make_parity_dataset(np.asarray(ctx.x_train), fx, scheme.k,
                                     scheme, j, rng)
        pp = ctx.init_fn(ctx.seed + 17 * j)
        trainer = ParityTrainer(fwd=ctx.pfwd)
        pp, _ = trainer.train(pp, pq, tg, batch=ctx.batch, epochs=ctx.epochs,
                              seed=ctx.seed + j)
        parity_params.append(pp)
    return parity_params


def train_parity_models(deployed_params, fwd, init_fn, x_train, k, r=None,
                        scheme="sum", epochs=5, seed=0, batch=64,
                        use_true_labels=False, labels=None, n_classes=None,
                        encoder_kind=None, parity_fwd=None, device="cuda"):
    """End-to-end §3.3 pipeline, dispatched through the scheme-owned
    ``provision_parity(deployed_params, ctx)`` hook: trains one parity params
    list per parity row of ``scheme`` (a ``CodingScheme`` instance or
    registered name, resolved on ``device``; ``r`` defaults to 1 for names
    and to the scheme's own r for instances — an explicit mismatch raises).
    ``init_fn(seed)`` builds a fresh parity model on the same device as the
    deployed params.

    What provisioning means is the scheme's call: per-row distillation by
    default (``sum``/``concat``/``replication``/``approx_backup``); the
    joint encoder+parity objective for ``learned``, whose *returned scheme*
    carries the trained encoder; r references to ``deployed_params`` for
    ``approxifer`` and ``invnet``; a Fisher-weighted checkpoint merge for
    ``fisher``.

    ``parity_fwd`` lets the parity model be a different architecture from
    the deployed model (the approx_backup scheme's cheap backup); defaults
    to ``fwd``.

    Returns ``(list of scheme.r parity params, scheme)``."""
    if encoder_kind is not None:
        raise TypeError(
            "train_parity_models(encoder_kind=...) was removed; pass "
            "scheme= (a registered name or CodingScheme instance), e.g. "
            "train_parity_models(..., scheme='sum')")
    scheme = get_scheme(scheme, k=k, r=r, device=device)
    ctx = ParityTrainContext(
        fwd=fwd, init_fn=init_fn, x_train=x_train, epochs=epochs, seed=seed,
        batch=batch, use_true_labels=use_true_labels, labels=labels,
        n_classes=n_classes, parity_fwd=parity_fwd, scheme=scheme)
    hook = getattr(type(scheme), "provision_parity", None)
    if hook is None:
        parity_params = default_provision(scheme, deployed_params, ctx)
    else:
        parity_params = hook(scheme, deployed_params, ctx)
    return parity_params, ctx.scheme
