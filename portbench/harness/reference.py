"""The plain reference: a decoder-only transformer (dense SwiGLU or a
DeepSeekMoE layer of routed and shared experts) written from the
architecture, in plain PyTorch and float32 (TF32 off), one sequence at a
time.  It imports nothing of the program: it reads the configuration file's
keys and the weights the benchmark drew, in their layout (per-layer leaves
stacked on a leading axis, dense weights [in, out]), and works out
everything else again.

* Attention: RMS-normed input, q/k/v projections, per-head RMS norm of q
  and k where ``qk_norm``, rotary embedding (rotate-half, angle
  pos * theta^(-i / (hd/2))), causal softmax over hd^-0.5-scaled scores,
  grouped heads (query head h reads KV head h // (H / KV)).
* MoE: softmax router in fp32, the top-k experts' gates renormalised (floor
  1e-9), SwiGLU experts, shared experts added.  The capacity rule the
  configuration states: the tokens of one prefill (the first
  ``prefill_len`` positions) form one batch; each (token, k) assignment
  takes its place within its expert in token-major order, and one at a
  place >= C = max(8, ceil8(ceil(T K cf / E))) is dropped.  A decode step's
  batch of ``decode_batch`` tokens can put at most one assignment on an
  expert per token, so none is dropped while C(decode_batch) >=
  decode_batch; the reference refuses a cell where that does not hold.
  The assignments each prefill drops are counted (``moe_counts``).
* ``quant="fp8"`` is the control: every matrix product's weight (per
  output column) and input (per row) rounded to float8 e4m3 with an fp32
  scale, products and everything else in fp32.
* ``quant="router_bf16"`` is a witness, not a control: all in fp32 but the
  router's input, rounded through bfloat16 as the program's hidden state
  is; it counts the (token, layer) routings whose top-k set that one
  rounding changes."""
from __future__ import annotations

import math

import torch


def _rms(x, scale=None, eps=1e-6):
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x if scale is None else x * scale.float()


def _q8(t, dim):
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg, params, quant=None, decode_batch=1):
        self.cfg, self.p, self.quant = cfg, params, quant
        self.prefills = []             # (assignments dropped, made) each
        self.flips = self.routings = 0
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cfg.get("n_experts") and self.capacity(decode_batch) < decode_batch:
            raise ValueError(
                f"a decode batch of {decode_batch} tokens can overflow an "
                f"expert of capacity {self.capacity(decode_batch)}: the "
                f"reference would need the batch's composition")

    # -- pieces -----------------------------------------------------------
    def mm(self, x, w):
        w = w.float()
        if self.quant == "fp8":
            return _q8(x, -1) @ _q8(w, 0)
        return x @ w

    def capacity(self, T):
        c = self.cfg
        n = math.ceil(T * c["moe_top_k"] * c.get("capacity_factor", 1.25)
                      / c["n_experts"])
        return max(8, -(-n // 8) * 8)

    def embed(self, ids):
        idx = torch.as_tensor(ids, device=self.p["embed"].device).long()
        return self.p["embed"][idx].float()

    def _rope(self, x, S):
        hd = x.shape[-1]
        half = hd // 2
        freqs = 1.0 / (self.cfg.get("rope_theta", 10000.0) ** (
            torch.arange(half, device=x.device, dtype=torch.float32) / half))
        ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
            * freqs[None]
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)

    def _attention(self, a, g, h):
        c = self.cfg
        S = h.shape[0]
        H, KV = c["n_heads"], c["n_kv_heads"]
        hd = c.get("head_dim") or c["d_model"] // H
        q = self.mm(h, a["wq"][g]).view(S, H, hd)
        k = self.mm(h, a["wk"][g]).view(S, KV, hd)
        v = self.mm(h, a["wv"][g]).view(S, KV, hd)
        if c.get("qkv_bias"):
            q = q + a["bq"][g].float().view(H, hd)
            k = k + a["bk"][g].float().view(KV, hd)
            v = v + a["bv"][g].float().view(KV, hd)
        if c.get("qk_norm"):
            q, k = _rms(q, a["q_norm"][g]), _rms(k, a["k_norm"][g])
        q, k = self._rope(q, S), self._rope(k, S)
        rep = H // KV
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # [H, S, hd]
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1) * hd ** -0.5
        out = torch.empty_like(q)
        kpos = torch.arange(S, device=h.device)
        for i in range(0, S, 512):
            s = q[:, i:i + 512] @ k.transpose(1, 2)           # [H, b, S]
            qpos = kpos[i:i + 512]
            s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None],
                              -math.inf)
            out[:, i:i + 512] = torch.softmax(s, -1) @ v
        return self.mm(out.transpose(0, 1).reshape(S, H * hd), a["wo"][g])

    def _swiglu(self, x, w1, w3, w2):
        return self.mm(torch.nn.functional.silu(self.mm(x, w1))
                       * self.mm(x, w3), w2)

    def _moe(self, m, g, h, prefill_len):
        c = self.cfg
        S = h.shape[0]
        E, K = c["n_experts"], c["moe_top_k"]
        router = m["router"][g].float()
        if self.quant == "router_bf16":
            exact = torch.topk(h @ router, K, dim=-1).indices
            h_r = h.bfloat16().float()
        else:
            h_r = h
        probs = torch.softmax(h_r @ router, -1)
        gates, idx = torch.topk(probs, K, dim=-1)             # [S, K]
        if self.quant == "router_bf16":
            self.flips += int((exact.sort(-1).values
                               != idx.sort(-1).values).any(-1).sum())
            self.routings += S
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        keep = torch.ones_like(gates, dtype=torch.bool)
        T = min(prefill_len, S)
        if T:
            flat = idx[:T].reshape(-1)
            onehot = torch.nn.functional.one_hot(flat, E)
            place = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
            keep[:T] = (place < self.capacity(T)).view(T, K)
            self._dropped += int((~keep[:T]).sum())
            self._made += T * K
        out = torch.zeros_like(h)
        for e in range(E):
            tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self._swiglu(h[tok], m["w1"][g][e], m["w3"][g][e],
                             m["w2"][g][e])
            out.index_add_(0, tok, gates[tok, slot][:, None] * y)
        if c.get("n_shared_experts"):
            sp = m["shared"]
            out = out + self._swiglu(h, sp["w1"][g], sp["w3"][g],
                                     sp["w2"][g])
        return out

    def moe_counts(self):
        """The share of expert assignments dropped for capacity, over all
        the prefills run and at most in one (%), and with the witness the
        share of routings flipped; empty for a dense model."""
        out = {}
        if self.prefills:
            d = sum(a for a, _ in self.prefills)
            n = sum(b for _, b in self.prefills)
            out["moe_dropped_pct"] = 100 * d / n
            out["moe_dropped_pct_max"] = max(100 * a / b
                                             for a, b in self.prefills)
        if self.routings:
            out["router_flip_pct"] = 100 * self.flips / self.routings
        return out

    # -- forward ----------------------------------------------------------
    @torch.no_grad()
    def logits(self, x, prefill_len, positions):
        """fp32 logits [len(positions), V] of the sequence whose input
        embeddings are ``x`` [S, D] (fp32), its first ``prefill_len``
        positions one prefill."""
        c = self.cfg
        layer = self.p["blocks"][0]
        self._dropped = self._made = 0
        for g in range(c["n_layers"]):
            a = layer["attn"]
            x = x + self._attention(a, g, _rms(x, a["norm"]["scale"][g]))
            if "moe" in layer:
                m = layer["moe"]
                x = x + self._moe(m, g, _rms(x, m["norm"]["scale"][g]),
                                  prefill_len)
            else:
                f = layer["mlp"]
                x = x + self._swiglu(_rms(x, f["norm"]["scale"][g]),
                                     f["w1"][g], f["w3"][g], f["w2"][g])
        if self._made:
            self.prefills.append((self._dropped, self._made))
        pos = torch.as_tensor(positions, device=x.device).long()
        y = _rms(x[pos], self.p["final_norm"]["scale"])
        head = self.p["embed"].T if c.get("tie_embeddings") else \
            self.p["lm_head"]
        return torch.cat([self.mm(y[i:i + 256], head)
                          for i in range(0, len(positions), 256)])
