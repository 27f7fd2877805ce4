"""Plain PyTorch versions of the CUDA kernels (B1-B8).

Each accumulates in fp32 and returns the input dtype, like the kernel it
stands beside.  The CPU path of ``kernels/ops.py`` runs these, and the chip
smoke test holds every kernel against them on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_encode_forward import fused_slices


def parity_encode_ref(queries, coeffs):
    """queries [k, B, F]; coeffs [k] -> parity [B, F], or [r, k] -> the r
    parity rows [r, B, F] (fp32 accumulate)."""
    acc = torch.einsum("...k,kbf->...bf", coeffs.float(), queries.float())
    return acc.to(queries.dtype)


def parity_decode_ref(parity_out, outputs, avail_coeffs, inv_c):
    """parity_out [B, V]; outputs [k, B, V]; avail_coeffs [k] (0 at the
    missing index, code coefficient elsewhere); inv_c scalar = 1/c_missing.
    Returns reconstruction [B, V]."""
    s = torch.einsum("k,kbv->bv", avail_coeffs.float(), outputs.float())
    inv_c = torch.as_tensor(inv_c, dtype=torch.float32,
                            device=parity_out.device)
    return ((parity_out.float() - s) * inv_c).to(parity_out.dtype)


def fused_encode_forward_ref(queries, coeffs, weights):
    """queries [k, B, F]; coeffs [r, k]; weights [r, F, V] (one first-layer
    matrix per parity row) -> [r, B, V]: encode over the coding dim, then
    each row's first forward matmul (fp32 accumulate throughout)."""
    enc = torch.einsum("rk,kbf->rbf", coeffs.float(), queries.float())
    out = torch.einsum("rbf,rfv->rbv", enc, weights.float())
    return out.to(queries.dtype)


def fused_encode_forward_split_ref(queries, coeffs, weights, S):
    """``fused_encode_forward_ref`` in B2's summation order on the card: F
    cut into the S slices of a cluster (``fused_slices``), one fp32 partial
    product per slice, the partials summed in rank order."""
    enc = torch.einsum("rk,kbf->rbf", coeffs.float(), queries.float())
    w = weights.float()
    out = torch.zeros((w.shape[0], enc.shape[1], w.shape[2]),
                      device=enc.device)
    for f0, f1 in fused_slices(queries.shape[2], S):
        out = out + torch.einsum("rbf,rfv->rbv", enc[..., f0:f1],
                                 w[:, f0:f1])
    return out.to(queries.dtype)


def learned_project_ref(h, w):
    """h [H, B, F]; w [H, r] -> [r, B, F]: out[j] = sum_h w[h, j] h[h]
    (fp32 accumulate, h's dtype).  The approxifer encode is this with
    ``w = C^T``."""
    acc = torch.einsum("hr,hbf->rbf", w.float(), h.float())
    return acc.to(h.dtype)


def multigroup_decode_ref(parity_outs, outputs, cmat):
    """parity_outs [G, B, V]; outputs [G, k, B, V]; cmat [G, k+1] (per-group
    availability-masked coeffs, 0 at the missing index, with 1/c_missing
    appended).  Returns [G, B, V] — the batched subtraction decode."""
    k = outputs.shape[1]
    s = torch.einsum("gk,gkbv->gbv", cmat[:, :k].float(), outputs.float())
    inv = cmat[:, k].float()[:, None, None]
    return ((parity_outs.float() - s) * inv).to(parity_outs.dtype)


NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd] -> [B,Sq,H,hd] in q's dtype: naive
    softmax in fp32, head h reading kv-head h // (H // KV).  Query row i sits
    at position i (no offset); masked scores are -1e30."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.float().reshape(B, Sq, KV, rep, hd) * hd ** -0.5
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_bf16p_ref(q, k, v, *, causal=True, window=0):
    """``flash_attention_ref`` with the one rounding that B7's tensor-core
    route adds: the unnormalised probabilities exp(s - rowmax) are rounded
    to bf16 before P.V (the A operand of ``wgmma``), while the row sum stays
    fp32.  A model of that route's numerics for the tests, not a second
    plain version: the kernel rounds each key tile's p against the running
    max of its online softmax, this against the row's final max."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.float().reshape(B, Sq, KV, rep, hd) * hd ** -0.5
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bgrqk,bkgd->bgrqd", p.to(torch.bfloat16).float(),
                     v.float()) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _decode_scores(q, k_cache, pos):
    """Scaled fp32 scores [B, KV, rep, S] of decode attention and the
    validity mask [B, S] (kpos <= pos[b])."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    qg = q.float().reshape(B, KV, H // KV, hd) * hd ** -0.5
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    return s, valid


def decode_attention_ref(q, k_cache, v_cache, pos):
    """q [B,H,hd]; caches [B,S,KV,hd]; pos a scalar or [B] per-row positions
    (valid slots: kpos <= pos[b]) -> [B,H,hd] in q's dtype, all in fp32.

    Unlike the JAX package's oracle, which broadcasts a vector ``pos``
    along the wrong axis, a ``[B]`` pos masks row b by ``pos[b]``."""
    B, H, hd = q.shape
    s, valid = _decode_scores(q, k_cache, pos)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_bf16p_ref(q, k_cache, v_cache, pos):
    """``decode_attention_ref`` with the one rounding that B8's tensor-core
    route adds: the unnormalised probabilities exp(s - rowmax) are rounded
    to bf16 before P.V (the A fragment of ``mma.sync``), while the row sum
    stays fp32.  A model of that route's numerics for the tests, not a
    second plain version: the kernel rounds each chunk's p against its
    warp's running max, this against the row's final max."""
    B, H, hd = q.shape
    s, valid = _decode_scores(q, k_cache, pos)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bgrk,bkgd->bgrd", p.to(torch.bfloat16).float(),
                     v_cache.float()) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, pos, splits, *,
                               bf16_p=False):
    """A model of B8's split-and-combine numerics for the tests: batch row
    b's slots are swept in the pieces ``splits[b]`` (a list of [begin, end)
    ranges, one per CTA of its cluster; empty ones allowed), each piece
    keeps its own max m, sum l and fp32 accumulator (P rounded to bf16
    before P.V when ``bf16_p``), and the pieces combine by rescaling to the
    global max, as the cluster's CTAs do."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    s, valid = _decode_scores(q, k_cache, pos)
    v = v_cache.float()
    out = torch.zeros((B, KV, H // KV, hd), dtype=torch.float32,
                      device=q.device)
    for b in range(B):
        parts = []
        for begin, end in splits[b]:
            if end <= begin:
                continue
            if not bool(valid[b, begin:end].all()):
                raise ValueError(f"split [{begin}, {end}) of row {b} passes "
                                 f"pos")
            sb = s[b, :, :, begin:end]
            m = sb.amax(dim=-1, keepdim=True)
            p = torch.exp(sb - m)
            pv = p.to(torch.bfloat16).float() if bf16_p else p
            acc = torch.einsum("grk,kgd->grd", pv, v[b, begin:end])
            parts.append((m, p.sum(dim=-1, keepdim=True), acc))
        if not parts:
            continue
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        num = sum(acc * torch.exp(m - big) for m, _, acc in parts)
        den = sum(l * torch.exp(m - big) for m, l, _ in parts)
        out[b] = num / den
    return out.reshape(B, H, hd).to(q.dtype)
