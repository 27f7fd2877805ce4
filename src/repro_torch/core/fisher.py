"""Fisher-averaged parity models: training-free provisioning by checkpoint
merging (Erasure Coded Neural Network Inference via Fisher Averaging,
arXiv:2409.01420).

When the k deployed members are neural checkpoints, a parity model can be
*merged* instead of trained: take the Fisher-information-weighted average of
the member checkpoints,

    theta*_j  =  ( sum_i  c_ji * F_i (.) theta_i )
                 / ( sum_i  c_ji * F_i )            (leaf-wise, elementwise)

where F_i is member i's diagonal Fisher — the expected squared gradient of
its own log-likelihood over a small calibration batch — and c_ji are the
parity row's combination weights.  Zero gradient steps run.

* **encode / decode** — the plain linear output code, with the Vandermonde
  coefficient rows normalised to sum to 1, so every parity query is a convex
  combination of the members and the merged model is evaluated
  in-distribution.
* **provision_parity** — each member's diagonal Fisher over ``calib_n``
  calibration samples from ``ctx.x_train``, merged leaf-wise through
  ``repro_torch.checkpoint.io.weighted_merge``.  ``deployed_params`` may be a
  list/tuple of k member checkpoints or one tree deployed across all k
  members (identical members merge to themselves).

The scheme is NOT ``model_agnostic``: the provisioned params are a merge
product, not references to the deployed params.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.convert import as_tensor, tree_leaves, tree_map
from repro_torch.core.scheme import (Capabilities, LinearScheme, _place,
                                     register_scheme)
from repro_torch.core.codes import vandermonde


def diag_fisher(fwd, params, x_calib):
    """Diagonal empirical Fisher of ``params`` under ``fwd`` over the
    calibration batch ``x_calib`` [n, ...]: per-leaf mean squared
    per-example gradient of the self-predicted negative log-likelihood
    (per-example gradients by ``torch.func.vmap`` over ``torch.func.grad``,
    on the parameters' device)."""
    params = tree_map(lambda t: t.detach(), params)
    x = as_tensor(np.asarray(x_calib), tree_leaves(params)[0].device)

    def nll(p, xi):
        logits = fwd(p, xi[None])[0]
        logp = torch.log_softmax(logits, dim=-1)
        # empirical Fisher at the model's own prediction (no labels needed:
        # calibration is unlabelled serving-side data)
        top = torch.argmax(logits.detach())
        return -torch.gather(logp, 0, top[None])[0]

    grads = torch.func.vmap(torch.func.grad(nll), in_dims=(None, 0))(
        params, x)
    return tree_map(lambda g: torch.mean(torch.square(g), dim=0), grads)


def _row_normalized_vandermonde(k, r):
    C = np.asarray(vandermonde(k, r), np.float64)   # C[j, i] = (i+1)**j > 0
    return (C / C.sum(axis=1, keepdims=True)).astype(np.float32)


@dataclass(frozen=True)
class FisherScheme(LinearScheme):
    """Linear code with row-stochastic coefficients + Fisher-merged parity
    provisioning; see module docstring.  ``calib_n`` caps the calibration
    batch drawn from ``ctx.x_train``; ``fisher_floor`` is added to every
    Fisher diagonal so zero-curvature leaves fall back to the plain
    coefficient-weighted convex average."""

    name: str = "fisher"
    calib_n: int = 64
    fisher_floor: float = 1e-8

    def __post_init__(self):
        _place(self, _row_normalized_vandermonde(self.k, self.r))

    def capabilities(self) -> Capabilities:
        # deliberately NOT model_agnostic: the provisioned parity params are
        # a merge product, not references to the deployed params
        return Capabilities()

    def provision_parity(self, deployed_params, ctx):
        """Fisher-weighted checkpoint merge — zero gradient steps.

        One merged tree per parity row j, member i weighted elementwise by
        ``c_ji * (F_i + fisher_floor)``."""
        from repro_torch.checkpoint.io import weighted_merge
        members = list(deployed_params) \
            if isinstance(deployed_params, (list, tuple)) \
            else [deployed_params] * self.k
        if len(members) != self.k:
            raise ValueError(
                f"fisher provisioning needs one checkpoint per member: got "
                f"{len(members)} for k={self.k}")
        x = np.asarray(ctx.x_train)[:self.calib_n]
        distinct = {}          # id -> fisher; one deployed checkpoint => one
        fishers = []           # fisher pass, not k identical ones
        for m in members:
            if id(m) not in distinct:
                distinct[id(m)] = diag_fisher(ctx.fwd, m, x)
            fishers.append(distinct[id(m)])
        C = np.asarray(self.host_coeffs, np.float64)             # [r, k]
        parity_params = []
        for j in range(self.r):
            weights = [
                tree_map(lambda f, c=float(C[j, i]): c * (f + self.fisher_floor),
                         fishers[i])
                for i in range(self.k)]
            parity_params.append(weighted_merge(members, weights))
        return parity_params


register_scheme(
    "fisher",
    lambda k, r=1, backend="kernels", **kw: FisherScheme(
        k=k, r=r, backend=backend, **kw))
