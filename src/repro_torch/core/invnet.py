"""Coded-InvNet-style scheme: encode through an invertible coupling network
(Coded-InvNet for Resilient Prediction Serving Systems, arXiv:2106.06445).

Conduct the linear code in the latent space of a small invertible network g,

    p_j  =  g^-1( sum_i  c_ji * g(x_i) )                (encode)

and serve the parities with the DEPLOYED model itself — no parity training.
Whenever the deployed model factors through g (F = head . g with a linear
head), the parity output is exactly the linear combination of the member
outputs, so the inherited ``LinearScheme`` output-code decode is exact —
bit-exact on an integer-valued invertible substrate.  For other deployed
models the same pipeline runs as an approximation.

``g`` is a stack of additive coupling layers over the flattened feature dim
(NICE-style): split features into halves (x1, x2),

    y2 = x2 + t(x1)        y1 = x1 + t'(y2)             (one layer, 2 steps)

with ``t`` a small pointwise scalar MLP shared across positions (params are
feature-size independent).  Additive coupling has an exact inverse by
subtraction.  The coupling's ``[H,B,F'] x [H,1] -> [1,B,F']`` projection runs
the learned-projection kernel (B5, ``ops.learned_project_op``) under
``backend="kernels"``.

Because ``encode`` is overridden (non-linear), ``fused_parity_outputs``
takes its exact unfused fallback.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.convert import as_tensor, resolve_device, tree_map
from repro_torch.core.scheme import Capabilities, LinearScheme, register_scheme


def init_coupling_params(hidden=8, seed=0, n_layers=2, device="cuda"):
    """Deterministic coupling-MLP params from a ``torch.Generator`` seeded
    with ``seed``: ``n_layers`` layers, each a pointwise scalar MLP
    ``u -> w2^T relu(w1 * u + b1)`` (w1 [H], b1 [H], w2 [H, 1])."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    layers = []
    for _ in range(n_layers):
        layers.append({
            "w1": (torch.randn((hidden,), generator=g) * 0.8).to(dev),
            "b1": (torch.randn((hidden,), generator=g) * 0.1).to(dev),
            "w2": (torch.randn((hidden, 1), generator=g)
                   * (0.5 / hidden)).to(dev),
        })
    return layers


def _shift(layer, u, use_kernels=False):
    """Pointwise coupling shift t(u): u [B, F'] -> [B, F'] through the
    scalar MLP; the [H,B,F'] x [H,1] projection runs the learned-projection
    kernel under ``use_kernels``."""
    h = torch.relu(torch.einsum("h,bf->hbf", layer["w1"], u)
                   + layer["b1"][:, None, None])
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.learned_project_op(h, layer["w2"])[0]
    return torch.einsum("hr,hbf->rbf", layer["w2"], h)[0]


def _pad_to(t, f):
    """Zero-pad / truncate the shift's feature dim to ``f`` (odd feature
    counts make the halves unequal; padding keeps coupling invertible)."""
    if t.shape[1] == f:
        return t
    if t.shape[1] > f:
        return t[:, :f]
    return F.pad(t, (0, f - t.shape[1]))


def _g_forward_flat(layers, x, use_kernels=False):
    """x [B, F] -> g(x) [B, F]: additive coupling, alternating halves."""
    f1 = x.shape[1] // 2
    x1, x2 = x[:, :f1], x[:, f1:]
    for layer in layers:
        x2 = x2 + _pad_to(_shift(layer, x1, use_kernels), x2.shape[1])
        x1 = x1 + _pad_to(_shift(layer, x2, use_kernels), x1.shape[1])
    return torch.cat([x1, x2], dim=1)


def _g_inverse_flat(layers, y, use_kernels=False):
    """Exact inverse of ``_g_forward_flat`` by subtraction, reversed."""
    f1 = y.shape[1] // 2
    y1, y2 = y[:, :f1], y[:, f1:]
    for layer in reversed(layers):
        y1 = y1 - _pad_to(_shift(layer, y2, use_kernels), y1.shape[1])
        y2 = y2 - _pad_to(_shift(layer, y1, use_kernels), y2.shape[1])
    return torch.cat([y1, y2], dim=1)


@dataclass(frozen=True)
class InvNetScheme(LinearScheme):
    """Invertible-coupling encode over the Vandermonde output code; see
    module docstring.  ``coupling_params=None`` initialises deterministic
    couplings from ``coupling_seed``."""

    hidden: int = 8
    n_layers: int = 2
    coupling_seed: int = 0
    coupling_params: Optional[list] = None
    name: str = "invnet"

    def __post_init__(self):
        super().__post_init__()
        params = self.coupling_params
        if params is None:
            params = init_coupling_params(self.hidden, self.coupling_seed,
                                          self.n_layers, device=self._dev)
        # numpy or host trees (checkpoints, the reference's params) land on
        # the scheme's device; tensors already there pass through uncopied
        object.__setattr__(self, "coupling_params",
                           tree_map(lambda a: as_tensor(a, self._dev),
                                    params))

    def capabilities(self) -> Capabilities:
        # model_agnostic: the deployed model serves the coupled parity
        # queries — provisioning returns references, never trains
        return Capabilities(model_agnostic=True)

    def provision_parity(self, deployed_params, ctx):
        """No parity training: the deployed model serves g^-1-space parity
        queries (exactly when it factors through g, approximately
        otherwise)."""
        del ctx
        return [deployed_params] * self.r

    def with_params(self, coupling_params):
        """A copy of this scheme serving ``coupling_params`` (checkpoint
        deserialization path, mirroring ``LearnedScheme.with_params``)."""
        return replace(self, coupling_params=coupling_params)

    @property
    def _use_kernels(self):
        return self.backend == "kernels"

    def g_forward(self, x):
        """x [B, ...] -> g(x) [B, ...]: the invertible representation the
        linear code is conducted in, applied per sample over the flattened
        trailing feature dims."""
        x = self._t(x).float()
        flat = x.reshape(x.shape[0], -1)
        out = _g_forward_flat(self.coupling_params, flat, self._use_kernels)
        return out.reshape(x.shape)

    def g_inverse(self, y):
        y = self._t(y).float()
        flat = y.reshape(y.shape[0], -1)
        out = _g_inverse_flat(self.coupling_params, flat, self._use_kernels)
        return out.reshape(y.shape)

    def encode(self, queries):
        """[k, ...] -> [r, ...]:  g^-1( coeffs @ g(queries) ),  the linear
        code conducted per sample in g's latent space.  Queries are read as
        [k, B, features...] (B = 1 when absent)."""
        q = self._t(queries).float()
        assert q.shape[0] == self.k, q.shape
        flat = q.reshape(self.k, q.shape[1], -1) if q.ndim >= 3 else \
            q.reshape(self.k, 1, -1)                       # [k, B, F]
        k, b, f = flat.shape
        lat = _g_forward_flat(self.coupling_params, flat.reshape(k * b, f),
                              self._use_kernels).reshape(k, b, f)
        enc = torch.einsum("rk,kbf->rbf", self.coeffs.to(lat.dtype), lat)
        out = _g_inverse_flat(self.coupling_params,
                              enc.reshape(self.r * b, f), self._use_kernels)
        return out.reshape((self.r,) + tuple(q.shape[1:]))

    __call__ = encode


register_scheme(
    "invnet",
    lambda k, r=1, backend="kernels", **kw: InvNetScheme(
        k=k, r=r, backend=backend, **kw))
