"""Pluggable coding-scheme layer: the ``CodingScheme`` protocol + registry.

ParM's central claim (paper §3.2-§3.5) is that the *code* is a swappable,
simple component — the learning lives in the parity model.  Every
encoder/decoder pair is a ``CodingScheme`` with a uniform surface

    scheme.encode(queries)                      # [k, ...] -> [r, ...]
    scheme.decode(parity_outs, outputs, missing_mask, parity_avail=None)
    scheme.decode_one(parity_out, outputs, missing_idx)   # r=1 hot path
    scheme.coeffs                               # [r, k] device tensor
    scheme.host_coeffs                          # [r, k] numpy copy
    scheme.k, scheme.r, scheme.name, scheme.device

and both serving layers (``repro_torch.serving.runtime`` and
``repro_torch.serving.simulator``) resolve schemes *only* through the
registry:

    register_scheme("myscheme", factory)        # one file, one call
    get_scheme("myscheme", k=4, r=2, backend="kernels", device="cuda")

Built-in entries:

* ``sum``          — the paper's addition/Vandermonde code (§3.2, §3.5).
* ``concat``       — the task-specific downsample-and-grid image code (§4.2.3).
* ``replication``  — each query mirrored (r = k identity code); decode is a
                     passthrough.
* ``approx_backup``— §5.2.6 approximate backups expressed as a degraded-
                     quality scheme: k = 1 groups, one cheap backup model per
                     group, decode is a passthrough of the backup output.
* ``learned``      — ``repro_torch.core.learned.LearnedScheme``: a trainable
                     encoder (Vandermonde base code + a small MLP residual
                     over the coding dimension) trained jointly with the
                     parity models; decode is the linear output code.
* ``approxifer``   — ``repro_torch.core.approxifer.ApproxIFERScheme``: the
                     rational-interpolation code; no parity model is trained
                     (``model_agnostic``), the decoder adapts its arity to
                     the responses that arrived and votes out erroneous ones
                     when it holds surplus responses (``detects_errors``).
* ``fisher``       — ``repro_torch.core.fisher.FisherScheme``: training-free
                     parity models by Fisher-weighted merging of the deployed
                     checkpoints (``checkpoint/io.py``); linear output code
                     with row-stochastic coefficients.
* ``invnet``       — ``repro_torch.core.invnet.InvNetScheme``: the linear
                     code conducted in the latent space of an invertible
                     additive-coupling network g (parities are
                     g^-1(C @ g(x))); no parity training.

Schemes live on a device (``device``, default ``"cuda"``; construction raises
when no card is present and ``"cpu"`` was not asked for).  They take numpy
arrays or tensors and return tensors on that device.

Capability flags are declared by a scheme's ``capabilities() ->
Capabilities`` method and read by every train / serving / eval call site
through ``scheme_capabilities(scheme)``.  Parity-model provisioning is
scheme-owned: ``provision_parity(deployed_params, ctx)`` returns the r parity
params lists, with ``repro_torch.core.parity.default_provision`` as the
distillation default.

``backend="torch" | "kernels"`` selects the implementation of the hot paths:
``kernels`` (the default) routes encode / r=1 decode / the fused encode and
first matmul / the batched decode / the learned and coupling projections /
the approxifer encode through ``repro_torch.kernels.ops`` — the hand-written
CUDA kernels on a CUDA device, their plain versions on the CPU — and
``torch`` runs plain tensor code.  The general r>1 least-squares decode
is always plain torch: a tiny [k, k] solve off the latency-critical path.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, fields
from typing import Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.convert import as_tensor, resolve_device
from repro_torch.core.codes import ConcatEncoder, solve_or_nan, vandermonde

BACKENDS = ("torch", "kernels")


@runtime_checkable
class CodingScheme(Protocol):
    """Structural protocol every coding scheme satisfies (duck-typed; concrete
    schemes need not inherit from anything)."""

    k: int
    r: int
    name: str

    @property
    def coeffs(self): ...                                     # [r, k]

    def encode(self, queries): ...                            # [k,...]->[r,...]

    def decode(self, parity_outs, outputs, missing_mask,
               parity_avail=None): ...

    def decode_one(self, parity_out, outputs, missing_idx): ...


# ----------------------------------------------------------- capabilities ---
@dataclass(frozen=True)
class Capabilities:
    """The declared capability surface of a coding scheme.

    * ``model_agnostic`` — no parity model is trained: the deployed model
      itself serves the encoded queries;
    * ``trainable``      — the encoder has trainable parameters, optimised
      jointly with the parity models;
    * ``fixes_k``        — the scheme owns its group size (approx_backup:
      k = 1) independent of the caller's redundancy-budget k;
    * ``dynamic_arity``  — recoverability is a response COUNT, not a fixed
      mask rule;
    * ``detects_errors`` — the decoder can vote out erroneous (Byzantine)
      responses from surplus ones;
    * ``approximate``    — reconstructions are degraded-quality; the DES
      runs the parity pool at ``cfg.approx_speedup``.
    """

    model_agnostic: bool = False
    trainable: bool = False
    fixes_k: bool = False
    dynamic_arity: bool = False
    detects_errors: bool = False
    approximate: bool = False


class _deprecated_flag:
    """Class-attribute descriptor keeping the pre-``capabilities()`` boolean
    flags readable one release: reading warns toward
    ``scheme_capabilities()`` and returns the declared value."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __get__(self, obj, objtype=None):
        warnings.warn(
            f"reading scheme.{self.name} is deprecated; use "
            f"repro_torch.core.scheme.scheme_capabilities(scheme)."
            f"{self.name}", DeprecationWarning, stacklevel=2)
        return self.value


def scheme_capabilities(scheme) -> Capabilities:
    """THE capability-dispatch entry point for train/serving/eval layers.

    Schemes that define ``capabilities()`` are read through it; schemes
    that still declare the old boolean class attributes get them collected
    into a ``Capabilities`` record with a ``DeprecationWarning``; schemes
    declaring neither get the default (all-False) record."""
    fn = getattr(type(scheme), "capabilities", None)
    if fn is not None:
        return fn(scheme)
    found = {}
    for f in fields(Capabilities):
        v = getattr(scheme, f.name, None)
        if v is not None:
            found[f.name] = bool(v)
    if found:
        warnings.warn(
            f"scheme {getattr(scheme, 'name', scheme)!r} declares "
            f"capability attributes ({sorted(found)}) but no "
            f"capabilities() method; attribute-style flags are deprecated "
            f"— define capabilities() -> Capabilities",
            DeprecationWarning, stacklevel=2)
    return Capabilities(**found)


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def recoverable_rows(scheme, missing_mask, parity_avail):
    """Which missing rows can be reconstructed right now?

    The single recoverability rule BOTH serving layers consult, so their
    decode decisions cannot drift.  A scheme may refine it with an optional
    ``recoverable(missing_mask, parity_avail)`` method (replication's
    per-row replica arrival); the default is the MDS rule — all-or-nothing
    while #missing <= #parities arrived.
    """
    missing_mask = np.asarray(missing_mask, bool)
    parity_avail = np.asarray(parity_avail, bool)
    rec_fn = getattr(scheme, "recoverable", None)
    if rec_fn is not None:
        return np.asarray(rec_fn(missing_mask, parity_avail), bool)
    if missing_mask.sum() <= parity_avail.sum():
        return missing_mask
    return np.zeros_like(missing_mask)


def decode_cost(scheme, n_missing):
    """Relative decode cost for reconstructing ``n_missing`` rows, in units
    of one r=1 subtraction decode (the calibration point of
    ``SimConfig.decode_ms``).  Schemes may provide their own
    ``decode_cost(n_missing)``; the default models the r>1 masked
    least-squares path as scaling linearly with the missing count."""
    fn = getattr(scheme, "decode_cost", None)
    if fn is not None:
        return float(fn(n_missing))
    return 1.0 if n_missing <= 1 else float(n_missing)


def encode_cost(scheme):
    """Relative encode cost per coding group, in units of one linear-
    combination encode (the calibration point of ``SimConfig.encode_ms``).
    Schemes may provide their own ``encode_cost()``; identity "encodes"
    (replication, approximate backups) charge 0 — no frontend math runs."""
    fn = getattr(scheme, "encode_cost", None)
    if fn is not None:
        return float(fn())
    return 1.0


def _kernel_encode(queries, coeffs):
    """Route encode through the encode kernel: all r parity rows from one
    launch; coeffs [r, k] are host values (launch parameters)."""
    from repro_torch.kernels import ops
    q = queries
    batched = q.ndim > 1
    if not batched:                       # [k] -> [k, 1]
        q = q[:, None]
    if q.ndim == 2:                       # [k, F] -> [k, 1, F]
        out = ops.parity_encode_op(q[:, None, :], coeffs)[:, 0]
    else:
        out = ops.parity_encode_op(q, coeffs)
    return out if batched else out[:, 0]


def _kernel_decode_many(parity_outs, outputs, missing_idxs, coeffs):
    """Route the batched r=1 subtraction decode through the multigroup
    kernel: all G stacked groups reconstructed in one launch; missing_idxs
    and coeffs [k] are host values (launch parameters)."""
    from repro_torch.kernels import ops
    outs, po = outputs, parity_outs
    G, k = outs.shape[:2]
    batched = outs.ndim > 3
    flat = outs.reshape(G, k, 1, -1) if not batched else \
        outs.reshape(G, k, outs.shape[2], -1)
    pf = po.reshape((G,) + tuple(flat.shape[2:]))
    out = ops.multigroup_decode_op(pf, flat, missing_idxs, coeffs)
    return out.reshape(po.shape)


def _kernel_decode_one(parity_out, outputs, missing_idx, coeffs):
    """Route the r=1 subtraction decode through the decode kernel; coeffs
    [k] are host values (the kernel takes them as launch parameters)."""
    from repro_torch.kernels import ops
    outs, po = outputs, parity_out
    k = outs.shape[0]
    batched = outs.ndim > 2
    flat = outs.reshape(k, 1, -1) if not batched else \
        outs.reshape(k, outs.shape[1], -1)
    pf = po.reshape(flat.shape[1:])
    out = ops.parity_decode_op(pf, flat, missing_idx, coeffs=coeffs)
    return out.reshape(po.shape)


def _place(scheme, coeffs_np):
    """Validate backend and device and store the [r, k] coefficients twice:
    as a device tensor for the math and as a host numpy copy for the
    host-side dataset builders."""
    _check_backend(scheme.backend)
    dev = resolve_device(scheme.device)
    object.__setattr__(scheme, "_dev", dev)
    object.__setattr__(scheme, "_host_coeffs",
                       np.asarray(coeffs_np, np.float32))
    object.__setattr__(scheme, "_coeffs",
                       torch.tensor(scheme._host_coeffs, device=dev))


@dataclass(frozen=True)
class LinearScheme:
    """The paper's addition code, generalised to r >= 1 Vandermonde rows
    (§3.5).  r=1 reduces to P = sum X_i with the subtraction decoder.

    All decode math reads ``self.coeffs``, so subclasses that override the
    coefficient matrix (or ``encode``) stay internally consistent."""

    k: int
    r: int = 1
    backend: str = "kernels"
    name: str = "sum"
    device: str = "cuda"

    def __post_init__(self):
        _place(self, vandermonde(self.k, self.r))

    @property
    def coeffs(self):
        return self._coeffs

    @property
    def host_coeffs(self):
        return self._host_coeffs

    def _t(self, x):
        return as_tensor(x, self._dev)

    def encode(self, queries):
        """queries [k, ...] -> parities [r, ...]."""
        queries = self._t(queries)
        assert queries.shape[0] == self.k, queries.shape
        if self.backend == "kernels":
            return _kernel_encode(queries, self.host_coeffs)
        c = self.coeffs.to(queries.dtype)
        return torch.tensordot(c, queries, dims=1)

    __call__ = encode

    def encode_forward(self, queries, weights):
        """Fused coded hot path: encode the [r, k] projection over the coding
        dim AND apply each parity row's first forward matmul in one launch.
        queries [k, B, ...] (trailing feature dims flattened to F); weights
        [r, F, V] — one first-layer matrix per parity row — or [F, V]
        shared.  Returns [r, B, V].  ``backend="kernels"`` runs
        ``kernels/fused_encode_forward.py``; torch is the plain path with
        the reference semantics (encode, then per-row matmul)."""
        queries = self._t(queries)
        assert queries.shape[0] == self.k, queries.shape
        weights = self._t(weights)
        if weights.ndim == 2:
            weights = weights[None].expand((self.r,) + tuple(weights.shape))
        if self.backend == "kernels":
            from repro_torch.kernels import ops
            return ops.fused_encode_forward_op(queries, self.coeffs, weights)
        flat = queries.reshape(queries.shape[0], queries.shape[1], -1)
        c = self.coeffs.to(flat.dtype)
        enc = torch.tensordot(c, flat, dims=1)                  # [r, B, F]
        return torch.einsum("rbf,rfv->rbv", enc, weights.to(flat.dtype))

    def decode_one(self, parity_out, outputs, missing_idx):
        """r=1 subtraction path: F_hat(X_j) = (F_P(P) - sum_{i!=j} c_i F(X_i))
        / c_j."""
        outs, po = self._t(outputs), self._t(parity_out)
        if self.backend == "kernels":
            return _kernel_decode_one(po, outs, missing_idx,
                                      self.host_coeffs[0])
        c = self.coeffs[0]                                      # [k]
        mask = torch.arange(self.k, device=self._dev) != missing_idx
        avail_sum = torch.einsum("k,k...->...", c * mask, outs.float())
        return (po.float() - avail_sum) / c[missing_idx]

    def decode_one_many(self, parity_outs, outputs, missing_idxs):
        """Batched ``decode_one`` over G stacked groups — ONE launch
        (``kernels/multigroup_decode.py``) instead of G per-group calls.
        parity_outs [G, ...]; outputs [G, k, ...]; missing_idxs [G] host
        ints (numpy, a list or a CPU tensor)."""
        outs, po = self._t(outputs), self._t(parity_outs)
        if self.backend == "kernels":           # indices stay on the host
            return _kernel_decode_many(po, outs, missing_idxs,
                                       self.host_coeffs[0])
        idx = torch.as_tensor(np.asarray(missing_idxs), dtype=torch.long,
                              device=self._dev)
        c = self.coeffs[0]                                      # [k]
        avail = c[None, :] * (torch.arange(self.k, device=self._dev)[None, :]
                              != idx[:, None])
        avail_sum = torch.einsum("gk,gk...->g...", avail, outs.float())
        inv = (1.0 / c[idx]).reshape((-1,) + (1,) * (po.ndim - 1))
        return (po.float() - avail_sum) * inv

    def decode_many(self, parity_outs, outputs, missing_masks,
                    parity_avail=None):
        """Batched ``decode`` over G stacked groups: the masked least-squares
        solve for every group in one batched call
        (``kernels/multigroup_decode.multigroup_lstsq``).  parity_outs
        [G, r, ...]; outputs [G, k, ...]; missing_masks [G, k]; parity_avail
        [G, r] (default all arrived).  Always plain torch, like ``decode``."""
        from repro_torch.kernels.multigroup_decode import multigroup_lstsq
        parity_outs = self._t(parity_outs)
        if parity_avail is None:
            parity_avail = torch.ones(parity_outs.shape[:2], dtype=torch.bool,
                                      device=self._dev)
        return multigroup_lstsq(self.coeffs, parity_outs, self._t(outputs),
                                self._t(missing_masks),
                                self._t(parity_avail))

    def decode(self, parity_outs, outputs, missing_mask, parity_avail=None):
        """General masked least-squares decode (exact while #missing <=
        #available parities; ``parity_avail`` [r] marks which parity outputs
        arrived).  Always plain torch — a [k, k] solve off the hot path."""
        C = self.coeffs                                  # [r, k]
        parity_outs = self._t(parity_outs).float()
        if parity_avail is not None:
            pa = self._t(parity_avail).float()[:, None]
            C = C * pa
            parity_outs = parity_outs * pa.reshape(
                (-1,) + (1,) * (parity_outs.ndim - 1))
        outs = self._t(outputs).float()
        missing_mask = self._t(missing_mask).bool()
        avail = (~missing_mask).float()
        rhs = parity_outs - torch.einsum(
            "rk,k...->r...", C * avail[None, :], outs)   # [r, ...]
        # Solve C_miss @ y = rhs for the missing columns via normal equations
        # restricted to missing columns: M = C * miss
        M = C * missing_mask.float()[None, :]                    # [r, k]
        G = M.T @ M + 1e-9 * torch.eye(self.k, device=self._dev)
        mt_rhs = torch.einsum("rk,r...->k...", M, rhs)
        flat = mt_rhs.reshape(self.k, -1)
        sol = solve_or_nan(G, flat).reshape(mt_rhs.shape)        # [k, ...]
        mm = missing_mask.reshape((self.k,) + (1,) * (outs.ndim - 1))
        return torch.where(mm, sol, outs)

    def capabilities(self) -> Capabilities:
        """Plain linear codes declare no special capabilities."""
        return Capabilities()

    def provision_parity(self, deployed_params, ctx):
        """Default provisioning: delegate to the per-row distillation owned
        by ``repro_torch.core.parity``."""
        from repro_torch.core.parity import default_provision  # circular
        return default_provision(self, deployed_params, ctx)


@dataclass(frozen=True)
class ConcatScheme(LinearScheme):
    """§4.2.3 task-specific image code: encode downsamples k images into a
    g x g grid (g = ceil(sqrt(k))), decode is the r=1 subtraction decoder over
    model *outputs* (the output code is still addition)."""

    name: str = "concat"

    def __post_init__(self):
        super().__post_init__()
        if self.r != 1:
            raise ValueError(
                f"concat scheme supports r=1 only, got r={self.r}")
        object.__setattr__(self, "_encoder", ConcatEncoder(self.k, 1))

    def encode(self, queries):
        """queries [k, B, H, W, C] -> [1, B, H, W, C]."""
        return self._encoder(self._t(queries))

    __call__ = encode


@dataclass(frozen=True)
class ReplicationScheme:
    """Replication expressed as a code: the coefficient matrix is I_k, so
    "encoding" mirrors each query (r = k parity queries) and decode is a
    passthrough — the j-th replica's output *is* the j-th reconstruction."""

    k: int
    r: Optional[int] = None       # always k; None means "let me set it"
    backend: str = "kernels"
    name: str = "replication"
    device: str = "cuda"

    def __post_init__(self):
        if self.r not in (None, self.k):
            raise ValueError(
                f"replication scheme has r == k, got r={self.r} k={self.k}")
        object.__setattr__(self, "r", self.k)
        _place(self, np.eye(self.k))

    @property
    def coeffs(self):
        return self._coeffs

    @property
    def host_coeffs(self):
        return self._host_coeffs

    def _t(self, x):
        return as_tensor(x, self._dev)

    def encode(self, queries):
        """Each query is its own parity query: [k, ...] -> [k, ...]."""
        queries = self._t(queries)
        assert queries.shape[0] == self.k, queries.shape
        return queries

    __call__ = encode

    def decode_one(self, parity_out, outputs, missing_idx):
        """Passthrough: the replica output is the reconstruction."""
        del outputs, missing_idx
        return self._t(parity_out)

    def decode(self, parity_outs, outputs, missing_mask, parity_avail=None):
        parity_outs = self._t(parity_outs)
        outputs = self._t(outputs)
        mm = self._t(missing_mask).bool().reshape(
            (self.k,) + (1,) * (outputs.ndim - 1))
        if parity_avail is not None:
            pa = self._t(parity_avail).bool().reshape(mm.shape)
            mm = mm & pa                  # only fill from arrived replicas
        return torch.where(mm, parity_outs, outputs)

    def recoverable(self, missing_mask, parity_avail):
        """Per-row rule (vs the MDS all-or-nothing default): a missing row is
        recoverable iff its own replica arrived."""
        return np.asarray(missing_mask) & np.asarray(parity_avail)

    def decode_cost(self, n_missing):
        """Decode is a passthrough copy — effectively free."""
        del n_missing
        return 0.0

    def encode_cost(self):
        """"Encoding" mirrors the queries — no frontend math runs."""
        return 0.0

    def capabilities(self) -> Capabilities:
        return Capabilities()

    def provision_parity(self, deployed_params, ctx):
        """Replicas are distilled copies: delegate to the default per-row
        distillation."""
        from repro_torch.core.parity import default_provision  # circular
        return default_provision(self, deployed_params, ctx)


@dataclass(frozen=True)
class ApproxBackupScheme(ReplicationScheme):
    """§5.2.6 approximate backups expressed as a degraded-quality coding
    scheme: every query is its own coding group (k = 1), the single "parity
    query" is the query itself, and the parity model is a *cheaper* backup
    model — decode passes its (approximate) output through."""

    k: int = 1
    name: str = "approx_backup"
    fixes_k = _deprecated_flag("fixes_k", True)
    approximate = _deprecated_flag("approximate", True)

    def capabilities(self) -> Capabilities:
        return Capabilities(fixes_k=True, approximate=True)

    def __post_init__(self):
        if self.k != 1:
            raise ValueError(
                f"approx_backup scheme has k == 1 (one cheap backup query "
                f"per group), got k={self.k}")
        super().__post_init__()


# --------------------------------------------------------------- registry ---
_SCHEMES: Dict[str, Callable[..., CodingScheme]] = {}


def register_scheme(name: str, factory: Callable[..., CodingScheme] = None,
                    *, override: bool = False):
    """Register a scheme factory ``factory(k, r, backend, **kw)`` under
    ``name``.  Usable as a decorator.  Registering a *different* factory
    under an existing name raises unless ``override=True``."""
    def _register(f):
        if not override and _SCHEMES.get(name, f) is not f:
            raise ValueError(
                f"coding scheme {name!r} is already registered; pass "
                f"override=True to replace it")
        _SCHEMES[name] = f
        return f
    if factory is None:
        return _register
    return _register(factory)


def list_schemes() -> list:
    """Introspection: registered scheme names, sorted."""
    return sorted(_SCHEMES)


def available_schemes():
    return list_schemes()


def get_scheme(scheme, k=None, r=None, *, backend=None, device=None,
               **kw) -> CodingScheme:
    """Resolve ``scheme`` to a CodingScheme.

    * a CodingScheme instance passes through, after validating it against
      any k / r / backend / device the caller explicitly asked for (``None``
      means "whatever the instance has").  Schemes with ``fixes_k``
      (approx_backup) own their group size, so the caller's k is not checked
      against them;
    * a string is looked up in the registry and instantiated with
      ``(k=k, r=r, backend=backend, device=device, **kw)`` (r defaults to 1,
      backend to "kernels", device to "cuda").
    """
    if not isinstance(scheme, str):
        if not isinstance(scheme, CodingScheme):
            raise TypeError(
                f"not a CodingScheme or registered name: {scheme!r}")
        if k is not None and scheme.k != k and \
                not scheme_capabilities(scheme).fixes_k:
            raise ValueError(
                f"scheme {scheme.name!r} has k={scheme.k}, but k={k} was "
                f"requested")
        if r is not None and scheme.r != r:
            raise ValueError(
                f"scheme {scheme.name!r} has r={scheme.r}, but r={r} was "
                f"requested")
        if backend is not None and \
                getattr(scheme, "backend", backend) != backend:
            raise ValueError(
                f"scheme {scheme.name!r} was built with "
                f"backend={scheme.backend!r}, but backend={backend!r} was "
                f"requested")
        if device is not None and torch.device(
                getattr(scheme, "device", device)).type != \
                torch.device(device).type:
            raise ValueError(
                f"scheme {scheme.name!r} lives on {scheme.device!r}, but "
                f"device={device!r} was requested")
        return scheme
    if scheme not in _SCHEMES:
        raise KeyError(
            f"unknown coding scheme {scheme!r}; registered: "
            f"{available_schemes()}")
    if k is None:
        raise ValueError("get_scheme(name, ...) requires k")
    return _SCHEMES[scheme](k=k, r=1 if r is None else r,
                            backend=backend or "kernels",
                            device=device or "cuda", **kw)


register_scheme("sum", LinearScheme)
register_scheme("concat", ConcatScheme)
register_scheme(
    "replication",
    # replication fixes r = k; accept and ignore the caller's r so generic
    # call sites (registry round-trip loops, frontends) need no special case
    lambda k, r=None, backend="kernels", **kw: ReplicationScheme(
        k=k, backend=backend, **kw))
register_scheme(
    "approx_backup",
    # the scheme fixes k = 1 and r = 1; the caller's k is the redundancy
    # budget, which sizes the backup pool, not the group
    lambda k=None, r=None, backend="kernels", **kw: ApproxBackupScheme(
        backend=backend, **kw))

# the other schemes live in their own modules and register themselves on
# import; import at the bottom: they subclass LinearScheme or use this
# module's helpers and call register_scheme from here
from repro_torch.core import learned as _learned  # noqa: E402
from repro_torch.core import approxifer as _approxifer  # noqa: E402
from repro_torch.core import fisher as _fisher  # noqa: E402
from repro_torch.core import invnet as _invnet  # noqa: E402

del _learned, _approxifer, _fisher, _invnet
