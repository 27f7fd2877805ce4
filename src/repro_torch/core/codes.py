"""Erasure-coding layer of ParM: encoders and decoders (paper §3.2, §3.5).

ParM deliberately keeps these *simple and fast* — the learning happens in the
parity model, not the code. We provide:

* ``SumEncoder``      — the paper's generic addition encoder, generalised to
                        r >= 1 parities with Vandermonde coefficient rows
                        (r=1, row [1, 1, ..., 1] reduces to P = sum X_i; §3.5's
                        k=2,r=2 example is rows [1,1] and [1,2]).
* ``LinearDecoder``   — the subtraction decoder for r=1 and, in general, the
                        small linear solve that reconstructs up to r missing
                        outputs from any k available (model ∪ parity) outputs.
* ``ConcatEncoder``   — the task-specific image encoder of §4.2.3: downsample
                        each of the k image queries and place them in a grid,
                        keeping the parity query the same size as one query.

All are plain PyTorch on the inputs' device; the hot paths also exist as CUDA
kernels in ``repro_torch.kernels`` (parity_encode / parity_decode) validated
against these.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.convert import as_tensor, resolve_device


def solve_or_nan(a, b):
    """``torch.linalg.solve(a, b)`` for (batched) square ``a``, except that
    a singular system gives NaN where ``torch.linalg.solve`` raises — what
    JAX's solve returns.  The rule reads ``solve_ex``'s ``info`` with
    ``torch.where`` on the device, so nothing syncs to the host, and it does
    not rely on the solver to produce NaN by itself."""
    x, info = torch.linalg.solve_ex(a, b)
    bad = (info != 0).reshape(tuple(info.shape) + (1,) * (x.ndim - info.ndim))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def vandermonde(k: int, r: int) -> np.ndarray:
    """Coefficient matrix C [r, k]: C[j, i] = (i+1)**j.

    Any square submatrix formed by the rows of [I_k; C] that can arise from
    <= r unavailabilities is invertible, which is what the decoder needs (MDS
    property of Vandermonde systems over the reals)."""
    return np.vander(np.arange(1, k + 1, dtype=np.float64), r,
                     increasing=True).T.copy()


@dataclass(frozen=True)
class SumEncoder:
    """P_j = sum_i C[j,i] * X_i over feature-aligned queries."""
    k: int
    r: int = 1
    device: str = "cuda"

    @property
    def coeffs(self):
        return torch.tensor(vandermonde(self.k, self.r), dtype=torch.float32,
                            device=resolve_device(self.device))

    def __call__(self, queries):
        """queries [k, ...] -> parities [r, ...]."""
        queries = as_tensor(queries, resolve_device(self.device))
        assert queries.shape[0] == self.k, queries.shape
        c = self.coeffs.to(queries.dtype)
        return torch.tensordot(c, queries, dims=1)


@dataclass(frozen=True)
class ConcatEncoder:
    """§4.2.3: downsample k images into a g x g grid (g = ceil(sqrt(k))).

    Output spatial size equals one input query, so parity-model input shape
    (and hence network bandwidth overhead, 1/k) is unchanged. r must be 1.
    Runs on the queries' device.
    """
    k: int
    r: int = 1

    def __call__(self, queries):
        """queries [k, B, H, W, C] -> [1, B, H, W, C]."""
        assert self.r == 1
        k, B, H, W, C = queries.shape
        g = math.ceil(math.sqrt(k))
        if H % g != 0 or W % g != 0:
            raise ValueError(
                f"ConcatEncoder with k={k} tiles a {g}x{g} grid, so image "
                f"height and width must be divisible by {g}; got H={H}, "
                f"W={W}. Pad or resize the queries first.")
        h, w = H // g, W // g
        # average-pool each query down to (h, w)
        q = queries.reshape(k * B, g, h, g, w, C).mean(dim=(1, 3))
        q = q.reshape(k, B, h, w, C)
        canvas = torch.zeros((B, H, W, C), dtype=queries.dtype,
                             device=queries.device)
        for i in range(k):
            rr, cc = divmod(i, g)
            canvas[:, rr * h:(rr + 1) * h, cc * w:(cc + 1) * w, :] = q[i]
        return canvas[None]


@dataclass(frozen=True)
class LinearDecoder:
    """Reconstructs missing deployed-model outputs from available model and
    parity-model outputs.

    r = 1 fast path is the paper's subtraction decoder:
        F_hat(X_j) = F_P(P) - sum_{i != j} F(X_i)
    General path solves  C[:, miss] @ Y_miss = parity_out - C[:, avail] @ Y_avail
    (least squares; exact when #missing <= #available parities).
    """
    k: int
    r: int = 1
    device: str = "cuda"

    @property
    def coeffs(self):
        return torch.tensor(vandermonde(self.k, self.r), dtype=torch.float32,
                            device=resolve_device(self.device))

    def decode_one(self, parity_out, outputs, missing_idx):
        """r=1 subtraction path. outputs [k, ...] with the missing row
        arbitrary; parity_out [...]. Returns reconstruction of that row."""
        dev = resolve_device(self.device)
        c = self.coeffs[0]                               # [k]
        outs = as_tensor(outputs, dev).float()
        mask = torch.arange(self.k, device=dev) != missing_idx
        avail_sum = torch.einsum("k,k...->...", c * mask, outs)
        po = as_tensor(parity_out, dev).float()
        return (po - avail_sum) / c[missing_idx]

    def decode(self, parity_outs, outputs, missing_mask, parity_avail=None):
        """General decode. parity_outs [r, ...]; outputs [k, ...] (garbage in
        missing rows); missing_mask [k] bool; ``parity_avail`` [r] bool marks
        which parity outputs arrived. Returns outputs with missing rows
        replaced by reconstructions (masked least squares, one static shape
        for any missing pattern)."""
        dev = resolve_device(self.device)
        C = self.coeffs                                  # [r, k]
        parity_outs = as_tensor(parity_outs, dev).float()
        if parity_avail is not None:
            pa = as_tensor(parity_avail, dev).float()[:, None]
            C = C * pa
            parity_outs = parity_outs * pa.reshape(
                (-1,) + (1,) * (parity_outs.ndim - 1))
        outs = as_tensor(outputs, dev).float()
        missing_mask = as_tensor(missing_mask, dev).bool()
        avail = (~missing_mask).float()
        rhs = parity_outs - torch.einsum(
            "rk,k...->r...", C * avail[None, :], outs)   # [r, ...]
        M = C * missing_mask.float()[None, :]            # [r, k]
        G = M.T @ M + 1e-9 * torch.eye(self.k, device=dev)
        mt_rhs = torch.einsum("rk,r...->k...", M, rhs)
        sol = solve_or_nan(G, mt_rhs.reshape(self.k, -1)).reshape(
            mt_rhs.shape)
        mm = missing_mask.reshape((self.k,) + (1,) * (outs.ndim - 1))
        return torch.where(mm, sol, outs)


def make_code(k, r=1, kind="sum"):
    """REMOVED: resolve codes through the scheme registry instead ::

        from repro_torch.core.scheme import get_scheme
        scheme = get_scheme("sum", k=k, r=r)   # or "concat", ...

    — schemes carry encode/decode/coeffs on one object and support backend
    selection.  Raises ``TypeError`` with this migration message."""
    raise TypeError(
        f"make_code(k={k}, r={r}, kind={kind!r}) was removed; use "
        f"repro_torch.core.scheme.get_scheme({kind!r}, k={k}, r={r}) — "
        f"schemes carry encode/decode/coeffs on one object and support "
        f"backend selection")
