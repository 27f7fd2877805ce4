"""Learned coding scheme: a trainable encoder through the scheme registry.

ParM pairs simple linear encoders with a learned parity model (paper §3);
learning the *code* as well can buy accuracy at the same overhead.
``LearnedScheme`` realises that extension point without touching either
serving layer:

* **encode** — the Vandermonde base code plus a small MLP residual applied
  across the coding dimension, pointwise per feature position::

      E_j(X)  =  sum_i C[j,i] X_i  +  alpha * (W2^T relu(W1^T X + b1))_j

  The residual path starts at ``alpha = 0``, so a fresh scheme encodes
  *exactly* the ``sum`` code, whatever numbers drew ``w1`` and ``w2``.
* **decode** — inherited from ``LinearScheme`` unchanged: the *output*-space
  code is still the ``coeffs`` combination the parity model is distilled
  toward.
* **training** — ``train_parity_models(..., scheme="learned")`` sees
  ``trainable`` and optimises encoder and parity models *jointly*
  (``repro_torch.core.parity._train_joint``); the returned scheme carries the
  trained, frozen encoder params for serving.
* **inference** — ``encode`` runs the frozen encoder; under
  ``backend="kernels"`` the linear base code runs the encode kernel (B1) and
  the final ``[H] -> [r]`` projection the learned-projection kernel (B5).
  ``encode_with_params`` — the joint-training objective — is always plain
  autograd-able torch: like the reference's kernels, B5 has no backward.

Encoder params are a plain tree (``{"w1", "b1", "w2", "alpha"}``) of
tensors on the scheme's device; ``repro_torch.checkpoint.io.save/load``
serialise them as-is and ``scheme.with_params(loaded)`` rebuilds the serving
scheme.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.convert import as_tensor, resolve_device, tree_map
from repro_torch.core.scheme import (Capabilities, LinearScheme,
                                     _deprecated_flag, _kernel_encode,
                                     register_scheme)


def init_encoder_params(k, r, hidden, seed=0, alpha=0.0, device="cuda"):
    """He-init MLP over the coding dimension, drawn from a
    ``torch.Generator`` seeded with ``seed``; ``alpha`` gates the residual
    path (0 = start exactly at the linear base code)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    return {
        "w1": (torch.randn((k, hidden), generator=g)
               * math.sqrt(2.0 / k)).to(dev),
        "b1": torch.zeros((hidden,), device=dev),
        "w2": (torch.randn((hidden, r), generator=g)
               * math.sqrt(1.0 / hidden)).to(dev),
        "alpha": torch.tensor(alpha, dtype=torch.float32, device=dev),
    }


def _encode_flat(enc, coeffs, q, use_kernels=False):
    """q [k, B, F] -> [r, B, F]: linear base code + alpha * MLP residual;
    coeffs [r, k] are host values under ``use_kernels`` (launch
    parameters), a tensor otherwise."""
    h = torch.relu(torch.einsum("kh,kbf->hbf", enc["w1"], q)
                   + enc["b1"][:, None, None])
    if use_kernels:
        from repro_torch.kernels import ops
        lin = _kernel_encode(q, coeffs)
        proj = ops.learned_project_op(h, enc["w2"])
    else:
        lin = torch.tensordot(coeffs.to(q.dtype), q, dims=1)
        proj = torch.einsum("hr,hbf->rbf", enc["w2"], h)
    return lin + enc["alpha"] * proj


def learned_encode(enc_params, coeffs, queries, use_kernels=False):
    """Shape-generic encode: ``[k, ...] -> [r, ...]`` for any trailing query
    shape.  Differentiable w.r.t. ``enc_params`` on the plain path."""
    q = queries.float()
    k = q.shape[0]
    r = coeffs.shape[0]
    flat = q.reshape(k, q.shape[1], -1) if q.ndim >= 3 else \
        q.reshape(k, 1, -1)
    out = _encode_flat(enc_params, coeffs, flat, use_kernels=use_kernels)
    return out.reshape((r,) + tuple(q.shape[1:]))


@dataclass(frozen=True)
class LearnedScheme(LinearScheme):
    """Trainable encoder over the Vandermonde base code; see module
    docstring.  ``enc_params=None`` initialises a fresh (identity-to-sum)
    encoder from ``enc_seed``."""

    hidden: int = 16
    enc_seed: int = 0
    enc_params: Optional[dict] = None
    name: str = "learned"

    trainable = _deprecated_flag("trainable", True)

    def capabilities(self) -> Capabilities:
        # trainable: train_parity_models switches to the joint
        # encoder+parity objective and returns the trained scheme
        return Capabilities(trainable=True)

    def __post_init__(self):
        super().__post_init__()
        enc = self.enc_params
        if enc is None:
            enc = init_encoder_params(self.k, self.r, self.hidden,
                                      self.enc_seed, device=self._dev)
        # numpy or host trees (checkpoints, the reference's params) land on
        # the scheme's device; tensors already there pass through uncopied
        object.__setattr__(self, "enc_params",
                           tree_map(lambda a: as_tensor(a, self._dev), enc))

    def encode(self, queries):
        """Frozen-encoder inference path ([k, ...] -> [r, ...])."""
        queries = self._t(queries)
        assert queries.shape[0] == self.k, queries.shape
        kernels = self.backend == "kernels"
        return learned_encode(self.enc_params,
                              self.host_coeffs if kernels else self.coeffs,
                              queries, use_kernels=kernels)

    __call__ = encode

    def encode_with_params(self, enc_params, queries):
        """Differentiable encode for the joint training objective (always
        plain torch: the projection kernel has no backward)."""
        return learned_encode(enc_params, self.coeffs, self._t(queries))

    def with_params(self, enc_params):
        """A copy of this scheme serving ``enc_params`` (the training
        hook's return path, and the deserialization path for checkpointed
        encoders)."""
        return replace(self, enc_params=enc_params)


register_scheme(
    "learned",
    lambda k, r=1, backend="kernels", **kw: LearnedScheme(
        k=k, r=r, backend=backend, **kw))
