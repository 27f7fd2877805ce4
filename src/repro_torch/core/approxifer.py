"""ApproxIFER-style rational-interpolation coding scheme ("approxifer").

ApproxIFER (Soleymani et al.) replaces ParM's learned parity models with a
*model-agnostic* interpolation code: treat the k queries of a coding group as
samples ``X_i = q(z_i)`` of a function over interpolation nodes ``z_i``, send
the interpolant's values at ``r`` extra nodes as the parity queries, and
serve EVERY query — originals and parities — with the *deployed* model
itself.  Because the output trajectory ``g(z) = F(q(z))`` is again
(approximately) a low-order function of ``z``, the decoder re-interpolates
``g`` through **whichever responses actually arrived** and reads the missing
members' outputs off the fit.

* **no training** — ``model_agnostic``: ``train_parity_models`` returns the
  deployed params as the "parity models".
* **dynamic decode arity** — ALL missing members decode as soon as the total
  number of arrived responses (available members + arrived parities) reaches
  k (``recoverable``), and ``decode`` consumes however many responses exist.
* **Byzantine robustness** — ``detects_errors``: with more than k responses
  in hand the decoder has surplus equations, so gross erroneous responses
  are voted out by subset consistency (``flag_errors``) and re-decoded from
  the clean remainder; correcting e corruptions needs 2e surplus responses.

Numerics: nodes are a combined Chebyshev grid over [-1, 1] (members and
parities interleaved), kept in numpy float64 as in the reference.  Encode is
the barycentric evaluation of the member interpolant at the parity nodes — a
fixed [r, k] linear map (``coeffs``), so under ``backend="kernels"`` it is
one ``berrut_encode`` launch — and decode fits a degree-(k-1)
Chebyshev-basis polynomial to the arrived responses by masked least squares.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from repro_torch.convert import as_tensor, to_host
from repro_torch.core.codes import solve_or_nan
from repro_torch.core.scheme import (Capabilities, _deprecated_flag,
                                     _kernel_decode_one, _place,
                                     register_scheme)


def chebyshev_nodes(n: int) -> np.ndarray:
    """n Chebyshev points of the first kind on (-1, 1), decreasing."""
    t = np.arange(1, n + 1, dtype=np.float64)
    return np.cos((2.0 * t - 1.0) * np.pi / (2.0 * n))


def split_nodes(k: int, r: int):
    """Interleave one combined Chebyshev grid of k + r points into member
    and parity nodes: parity nodes are spread evenly through the grid,
    members take the rest.  Deterministic in (k, r)."""
    n = k + r
    grid = chebyshev_nodes(n)
    pidx = sorted({int((s + 0.5) * n / r) for s in range(r)})
    midx = [t for t in range(n) if t not in pidx]
    return grid[midx], grid[pidx]


def lagrange_eval_matrix(nodes: np.ndarray, at: np.ndarray) -> np.ndarray:
    """L[j, i] = i-th Lagrange basis polynomial of ``nodes`` at ``at[j]``
    (barycentric form; float64 for conditioning)."""
    nodes = np.asarray(nodes, np.float64)
    at = np.asarray(at, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        bary = 1.0 / (at[:, None] - nodes[None, :])       # [m, n]
    exact = ~np.isfinite(bary)
    bary = np.where(exact, 0.0, bary)
    w = np.array([1.0 / np.prod(nodes[i] - np.delete(nodes, i))
                  for i in range(len(nodes))])            # barycentric weights
    num = bary * w[None, :]
    out = num / num.sum(axis=1, keepdims=True)
    # evaluation point coincides with a node: the basis is an indicator
    hit = exact.any(axis=1)
    out[hit] = exact[hit].astype(np.float64)
    return out


def chebyshev_design(nodes: np.ndarray, deg: int) -> np.ndarray:
    """Design matrix A[t, d] = T_d(nodes[t]) for d = 0..deg-1."""
    nodes = np.asarray(nodes, np.float64)
    a = np.empty((len(nodes), deg))
    a[:, 0] = 1.0
    if deg > 1:
        a[:, 1] = nodes
    for d in range(2, deg):
        a[:, d] = 2.0 * nodes * a[:, d - 1] - a[:, d - 2]
    return a


@dataclass(frozen=True)
class ApproxIFERScheme:
    """Rational-interpolation code with a straggler-adaptive decoder; see
    module docstring.  ``err_tol`` is the absolute residual above which a
    surplus-checked response is voted out as corrupted."""

    k: int
    r: int = 1
    backend: str = "kernels"
    name: str = "approxifer"
    err_tol: float = 100.0
    device: str = "cuda"

    model_agnostic = _deprecated_flag("model_agnostic", True)
    detects_errors = _deprecated_flag("detects_errors", True)
    dynamic_arity = _deprecated_flag("dynamic_arity", True)

    def capabilities(self) -> Capabilities:
        return Capabilities(model_agnostic=True, detects_errors=True,
                            dynamic_arity=True)

    def provision_parity(self, deployed_params, ctx):
        """No parity training: the deployed model itself serves the encoded
        queries, so the "parity models" are r references to the deployed
        params."""
        del ctx
        return [deployed_params] * self.r

    def __post_init__(self):
        if self.k < 2:
            raise ValueError(
                f"approxifer interpolates over k >= 2 queries, got "
                f"k={self.k}")
        if self.r < 1:
            raise ValueError(f"r must be >= 1, got r={self.r}")
        z, w = split_nodes(self.k, self.r)
        object.__setattr__(self, "_member_nodes", z)
        object.__setattr__(self, "_parity_nodes", w)
        # encode IS a fixed linear map: the member interpolant evaluated at
        # the parity nodes
        _place(self, lagrange_eval_matrix(z, w))                # [r, k]
        # decode design: T_0..T_{k-1} at every node (members then parities)
        design = chebyshev_design(np.concatenate([z, w]), self.k)
        object.__setattr__(self, "_design_np", design)          # [k + r, k]
        object.__setattr__(self, "_design", torch.tensor(
            design, dtype=torch.float32, device=self._dev))
        # r=1 hot path: reconstructing member j from the k - 1 other members
        # plus parity 0 is again a fixed linear map per j
        one = np.zeros((self.k, self.k + 1))
        for j in range(self.k):
            arr = np.concatenate([np.delete(z, j), w[:1]])
            lj = lagrange_eval_matrix(arr, z[j:j + 1])[0]       # [k]
            one[j, :self.k - 1] = lj[:self.k - 1]
            one[j, self.k] = lj[self.k - 1]
        object.__setattr__(self, "_decode_one_w", one)
        # ... expressed as subtraction-decode coefficients c, one row per
        # missing index: (parity - sum_{i != j} c_i out_i) / c_j
        # = beta * parity + alpha . out
        cvec = np.empty((self.k, self.k), np.float64)
        for j in range(self.k):
            beta, alpha = one[j, self.k], one[j, :self.k - 1]
            cvec[j, j] = 1.0 / beta
            cvec[j, np.arange(self.k) != j] = -alpha / beta
        # kept on the host too: the decode kernel takes them as launch
        # parameters
        host = cvec.astype(np.float32)
        object.__setattr__(self, "_decode_one_c_host", host)
        object.__setattr__(self, "_decode_one_c", torch.tensor(
            host, device=self._dev))

    @property
    def coeffs(self):
        return self._coeffs

    @property
    def host_coeffs(self):
        return self._host_coeffs

    @property
    def member_nodes(self):
        return self._member_nodes

    @property
    def parity_nodes(self):
        return self._parity_nodes

    def _t(self, x):
        return as_tensor(x, self._dev)

    # ------------------------------------------------------------- encode --
    def encode(self, queries):
        """queries [k, ...] -> parity queries [r, ...]: the member
        interpolant evaluated at the r extra Chebyshev nodes."""
        queries = self._t(queries)
        assert queries.shape[0] == self.k, queries.shape
        if self.backend == "kernels":
            from repro_torch.kernels import ops
            q = queries if queries.ndim > 1 else queries[:, None]
            out = ops.berrut_encode_op(q, self.coeffs)
            return out if queries.ndim > 1 else out[:, 0]
        c = self.coeffs.to(queries.dtype)
        return torch.tensordot(c, queries, dims=1)

    __call__ = encode

    def encode_cost(self):
        """One linear pass over the group — the calibration point."""
        return 1.0

    # ------------------------------------------------------------- decode --
    def decode(self, parity_outs, outputs, missing_mask, parity_avail=None):
        """Straggler-adaptive decode: fit the degree-(k-1) Chebyshev-basis
        interpolant through every response that arrived (masked least
        squares over the k + r node grid) and evaluate it at the missing
        members' nodes.  Always plain torch: a [k, k] solve off the hot
        path; a singular system gives NaN, as in the reference."""
        parity_outs = self._t(parity_outs).float()
        outs = self._t(outputs).float()
        missing_mask = self._t(missing_mask).bool()
        if parity_avail is None:
            parity_avail = torch.ones((self.r,), dtype=torch.bool,
                                      device=self._dev)
        avail = torch.cat([(~missing_mask).float(),
                           self._t(parity_avail).float()])       # [k + r]
        y = torch.cat([outs, parity_outs], dim=0)                # [k + r, ...]
        a = self._design * avail[:, None]                        # [k + r, k]
        g = a.T @ a + 1e-9 * torch.eye(self.k, device=self._dev)
        rhs = torch.einsum("td,t...->d...", a, y * avail.reshape(
            (-1,) + (1,) * (y.ndim - 1)))
        c = solve_or_nan(g, rhs.reshape(self.k, -1)).reshape(rhs.shape)
        fit = torch.einsum("td,d...->t...", self._design[:self.k], c)
        mm = missing_mask.reshape((self.k,) + (1,) * (outs.ndim - 1))
        return torch.where(mm, fit, outs)

    def decode_one(self, parity_out, outputs, missing_idx):
        """r=1 hot path: the refit through (k - 1 members + the parity) is
        a fixed linear combination per missing index, so it routes through
        the same subtraction-decode kernel as the linear codes."""
        outs, po = self._t(outputs), self._t(parity_out)
        if self.backend == "kernels":
            return _kernel_decode_one(po, outs, missing_idx,
                                      self._decode_one_c_host[missing_idx])
        c = self._decode_one_c[missing_idx]                     # [k]
        mask = torch.arange(self.k, device=self._dev) != missing_idx
        avail_sum = torch.einsum("k,k...->...", c * mask, outs.float())
        return (po.float() - avail_sum) / c[missing_idx]

    # ------------------------------------------------- dynamic-arity rules --
    def recoverable(self, missing_mask, parity_avail):
        """Dynamic arity: every missing member decodes as soon as the total
        arrived-response count (available members + arrived parities)
        reaches k."""
        missing_mask = np.asarray(missing_mask, bool)
        parity_avail = np.asarray(parity_avail, bool)
        arrived = (~missing_mask).sum() + parity_avail.sum()
        if arrived >= self.k:
            return missing_mask
        return np.zeros_like(missing_mask)

    def decode_cost(self, n_missing):
        """One refit of the [k, k] system serves ALL missing rows at once,
        so the hint is flat in n_missing (roughly two subtraction decodes
        of setup)."""
        del n_missing
        return 2.0

    # ---------------------------------------------------- Byzantine voting --
    def max_correctable(self, n_arrived: int) -> int:
        """Errors correctable from ``n_arrived`` responses: the surplus
        over k pays 2 responses per corrected error."""
        return max(0, (n_arrived - self.k) // 2)

    def flag_errors(self, member_outs, member_avail, parity_outs,
                    parity_avail):
        """Vote out grossly erroneous responses by subset consistency.

        Given the responses that arrived (``member_avail`` [k] /
        ``parity_avail`` [r] mark arrivals), search for the smallest set of
        e <= (n_arrived - k) / 2 responses whose removal leaves the rest
        consistent with one degree-(k-1) interpolant (residuals under
        ``err_tol``).  Returns boolean ``(member_flags [k], parity_flags
        [r])`` — all False when the group lacks the surplus to vote, or when
        everything is consistent.  Host numpy in float64, as in the
        reference: it runs on <= k + r responses."""
        member_avail = np.asarray(member_avail, bool)
        parity_avail = np.asarray(parity_avail, bool)
        mo = np.asarray(to_host(member_outs), np.float64).reshape(self.k, -1)
        po = np.asarray(to_host(parity_outs), np.float64).reshape(self.r, -1)
        idxs = np.concatenate([np.nonzero(member_avail)[0],
                               self.k + np.nonzero(parity_avail)[0]])
        n_t = len(idxs)
        mflags = np.zeros(self.k, bool)
        pflags = np.zeros(self.r, bool)
        e_max = self.max_correctable(n_t)
        if e_max < 1:
            return mflags, pflags
        vals = np.concatenate([mo, po], axis=0)[idxs]     # [n_t, D]
        design = self._design_np[idxs]                    # [n_t, k]

        def residual(sel):
            a = design[sel]
            y = vals[sel]
            c, *_ = np.linalg.lstsq(a, y, rcond=None)
            return np.abs(a @ c - y).max()

        if residual(np.arange(n_t)) <= self.err_tol:
            return mflags, pflags                          # all consistent
        for e in range(1, e_max + 1):
            for drop in combinations(range(n_t), e):
                keep = np.setdiff1d(np.arange(n_t), drop)
                if residual(keep) <= self.err_tol:
                    for t in drop:
                        node = idxs[t]
                        if node < self.k:
                            mflags[node] = True
                        else:
                            pflags[node - self.k] = True
                    return mflags, pflags
        return mflags, pflags                              # ambiguous: abstain


register_scheme(
    "approxifer",
    lambda k, r=1, backend="kernels", **kw: ApproxIFERScheme(
        k=k, r=r, backend=backend, **kw))
