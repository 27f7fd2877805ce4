"""Mixture-of-Experts FFN — GShard-style top-k routing with fixed expert
capacity, by scatter/gather dispatch (no [T, E, C] one-hot tensor is
materialised): the JAX package's ``models/moe.py`` on one card.

Routing runs in fp32 (``router`` is an fp32 leaf even in a bf16 model), the
top-k gates are renormalised with a 1e-9 floor, and each (token, k)
assignment takes its place within its expert from a cumsum over the
flattened [T*K] order.  Assignments at a place >= the capacity C are
dropped: they are scattered into an overflow row that the expert products
never see, and gathered back as zero.  Nothing here waits on the device
(no boolean indexing, no ``bincount``), so a decode step stays free of host
round trips.

Two execution paths, chosen as the reference chooses them:

* global (one card, the unit tests, a mesh whose ``model`` axis does not
  divide the experts): the scatter/gather above, with the reference's
  logical constraints (the identity without launcher rules);
* expert-parallel (``_moe_fwd_ep``: launcher rules carry a mesh whose
  ``model`` axis divides ``n_experts``): the reference's ``shard_map`` as a
  ``local_map`` over local shards.  Each model rank holds E/tp experts;
  routing is replicated, tokens are dispatched locally into an [E_loc, C, D]
  buffer whose capacity C counts the *local* tokens, expert weights are
  all-gathered along ``data`` when they are FSDP-sharded, and one sum over
  ``model`` combines the ranks' outputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import logical
from repro_torch.distributed.logical import constrain
from repro_torch.models.layers import _dense, make_norm, torch_dtype


def _draw(gen, shape, fan_in, dtype, device, lead=()):
    """N(0, 1/fan_in) weights in ``dtype``, drawn one stacked slice at a
    time: a stacked expert bank of a full-size model (deepseek-moe-16b's
    ``w1`` is [28, 64, 2048, 1408]) never exists as one fp32 draw."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for one in out.view((-1,) + tuple(shape)):
        one.copy_(torch.randn(shape, generator=gen, device=device)
                  / math.sqrt(fan_in))
    return out


def init_moe(cfg, gen, *, device="cpu", lead=()):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg)
    p = {
        # rounded through the model dtype, kept in fp32, as the reference
        # casts its draw
        "router": _draw(gen, (D, E), D, dt, device, lead).float(),
        "w1": _draw(gen, (E, D, Fd), D, dt, device, lead),
        "w3": _draw(gen, (E, D, Fd), D, dt, device, lead),
        "w2": _draw(gen, (E, Fd, D), Fd, dt, device, lead),
        "norm": make_norm(cfg, D, device=device, lead=lead),
    }
    if cfg.n_shared_experts:
        # shared experts fused into one dense SwiGLU of width n_shared * F
        SF = cfg.n_shared_experts * Fd
        p["shared"] = {"w1": _dense(gen, (D, SF), dt, device, lead),
                       "w3": _dense(gen, (D, SF), dt, device, lead),
                       "w2": _dense(gen, (SF, D), dt, device, lead)}
    return p


def expert_capacity(n_tokens, cfg):
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)   # round up to multiple of 8


def _gate(cfg, router, xt):
    """Gating of tokens xt [T, D]: (gate_vals [T*K] renormalised top-k
    gates, flat_e [T*K] expert of each (token, k) assignment, its one-hot
    [T*K, E] int32, aux scalar load-balance loss)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.moe_top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)          # [T, E]
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)          # [T, K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)               # renormalise
    flat_e = gate_idx.reshape(-1)                                # [T*K]
    onehot = (flat_e[:, None] == torch.arange(E, device=xt.device)).to(
        torch.int32)                                             # [T*K, E]
    # load-balance auxiliary loss (Switch/GShard form)
    ce = onehot.sum(0).float() / (T * K)                         # [E]
    aux = E * torch.sum(probs.mean(0) * ce)
    return gate_vals.reshape(-1), flat_e, onehot, aux


def route(cfg, router, xt, C):
    """Routing of tokens xt [T, D] over experts of capacity C:
    (gate_vals [T*K] renormalised top-k gates, flat_e [T*K] expert of each
    (token, k) assignment, pos [T*K] its place within the expert, keep
    [T*K] pos < C, aux scalar load-balance loss)."""
    gates, flat_e, onehot, aux = _gate(cfg, router, xt)
    # position of each (token, k) assignment within its expert, GShard cumsum
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) - 1).gather(
        1, flat_e[:, None])[:, 0].long()
    return gates, flat_e, pos, pos < C, aux


def moe_fwd(cfg, p, x, capacity=None):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar fp32), on the
    expert-parallel path under a mesh that divides the experts, else the
    global one (see the module's docstring)."""
    rules, sizes, mesh = logical.state()
    if (rules is not None and mesh is not None and sizes.get("model", 1) > 1
            and cfg.n_experts % sizes["model"] == 0):
        return _moe_fwd_ep(cfg, p, x, rules, sizes, mesh, capacity)
    return _moe_fwd_global(cfg, p, x, capacity)


def _sum_k(got, T, K, dtype):
    """The K gated expert outputs of each token summed (in fp32 for a bf16
    model) where the reference scatter-adds them; the terms are the same."""
    return got.reshape(T, K, -1).sum(1, dtype=torch.float32).to(dtype)


def _experts(xt, e_idx, pos, keep, gates, w1, w3, w2, C):
    """Tokens xt [T, D] through the SwiGLU experts w1/w3 [E, D, F],
    w2 [E, F, D] at their assignments (expert e_idx [T*K], place pos, kept
    where keep), gated and summed per token -> [T, D].  An assignment at
    pos >= C lands in the overflow row C, which the expert products do not
    read, and its gathered row is zeroed."""
    T, D = xt.shape
    K = e_idx.shape[0] // T
    # scatter tokens into per-expert buffers [E, C, D]
    tok_idx = torch.arange(T * K, device=xt.device) // K          # [T*K]
    buf = constrain(xt.new_zeros((w1.shape[0], C + 1, D)).index_put(
        (e_idx, torch.where(keep, pos, C)), xt[tok_idx],
        accumulate=True)[:, :C], ("experts", "capacity", None))
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    h = constrain(torch.bmm(h, w2), ("experts", "capacity", None))
    # gather back with gate weights
    got = h[e_idx, torch.clamp(pos, max=C - 1)]                  # [T*K, D]
    got = got * (gates * keep).to(got.dtype)[:, None]
    got = constrain(got, ("tokens", None), shape=(T, D))
    return constrain(_sum_k(got, T, K, xt.dtype), ("tokens", None))


def _moe_fwd_global(cfg, p, x, capacity=None):
    """The reference's global scatter/gather program."""
    B, S, D = x.shape
    T = B * S
    C = capacity or expert_capacity(T, cfg)
    x = constrain(x, ("batch", None, None))
    xt = constrain(x.reshape(T, D), ("tokens", None))
    gates, flat_e, pos, keep, aux = route(cfg, p["router"], xt, C)
    out = _experts(xt, flat_e, pos, keep, gates, p["w1"], p["w3"], p["w2"], C)

    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + (F.silu(xt @ sp["w1"]) * (xt @ sp["w3"])) @ sp["w2"]
    return out.reshape(B, S, D), aux


# --------------------------------------------------------------------------
# Expert-parallel path
# --------------------------------------------------------------------------
class _MeshSum(torch.autograd.Function):
    """Sum of a local tensor over mesh dimensions ``dims`` (times ``scale``)
    whose result every rank holds; the backward hands each rank the
    incoming gradient times ``grad_scale``, because the local inputs were
    partial terms of that sum."""

    @staticmethod
    def forward(ctx, x, mesh, dims, scale, grad_scale):
        for d in dims:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, d)))
        ctx.grad_scale = grad_scale
        return x * scale if scale != 1 else x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None, None, None


def _moe_fwd_ep(cfg, p, x, rules, sizes, mesh, capacity=None):
    """The reference's expert-parallel ``shard_map`` as a ``local_map``.

    A replicated input's gradient is a partial sum over the mesh axes whose
    ranks see other work (``model``: other experts; the batch axes: other
    tokens), and ``local_map`` is told so; the load-balance loss, a mean of
    the ranks' losses over every axis as in the reference, hands each rank
    its share of the gradient on those axes alone."""
    E, D = cfg.n_experts, cfg.d_model
    tp = sizes["model"]
    E_loc = E // tp
    names = tuple(mesh.mesh_dim_names)
    B, S, _ = x.shape
    # shard batch over the largest prefix of the batch axes that divides B
    batch_axes = []
    n_batch_shards = 1
    for a in rules.get("batch", ("data",)):
        if a not in sizes:
            continue
        if B % (n_batch_shards * sizes[a]) == 0:
            batch_axes.append(a)
            n_batch_shards *= sizes[a]
        else:
            break
    T_loc = (B // n_batch_shards) * S
    C = capacity or expert_capacity(T_loc, cfg)
    has_shared = bool(cfg.n_shared_experts)
    fsdp = rules.get("fsdp_params", True) and "data" in sizes
    data_dim = names.index("data") if fsdp else None
    model_dim = names.index("model")
    partial_axes = set(batch_axes) | {"model"}
    n_partial = math.prod(sizes[a] for a in partial_axes)
    all_dims = tuple(range(len(names)))

    def gather(w, dim):
        if not fsdp:
            return w
        return funcol.all_gather_tensor_autograd(w, dim, (mesh, data_dim))

    def inner(xb, router, w1, w3, w2, *shared_w):
        # xb [B_loc, S, D]; router [D, E] (replicated);
        # w1/w3 [E_loc, D(_loc), F]; w2 [E_loc, F, D(_loc)]
        m_idx = mesh.get_local_rank("model")
        xt = xb.reshape(-1, D)
        gates, flat_e, _, aux = _gate(cfg, router, xt)
        # local aux loss, averaged over every mesh axis (identical on the
        # model ranks: routing inputs are replicated over 'model')
        aux = _MeshSum.apply(aux, mesh, all_dims, 1.0 / mesh.size(),
                             1.0 / n_partial)

        # assignments owned by this model rank's experts; the rest, and
        # those at a place >= C, land in the overflow row C
        local_e = flat_e - m_idx * E_loc
        own = (local_e >= 0) & (local_e < E_loc)
        le = torch.where(own, local_e, 0)
        slot = torch.where(own, local_e, E_loc)
        oh = (slot[:, None] == torch.arange(E_loc + 1, device=xt.device)).to(
            torch.int32)
        pos = (torch.cumsum(oh, 0, dtype=torch.int32) - 1).gather(
            1, slot[:, None])[:, 0].long()
        pos = torch.where(own, pos, C)
        # FSDP gather of this rank's expert weights (per layer, transient);
        # the inference layout (fsdp_params=False) keeps them resident
        out = _experts(xt, le, pos, pos < C, gates, gather(w1, 1),
                       gather(w3, 1), gather(w2, 2), C)
        if has_shared:
            sw1, sw3, sw2 = shared_w                             # [D(_loc),SF_loc]
            sh = F.silu(xt @ gather(sw1, 0)) * (xt @ gather(sw3, 0))
            out = out + sh @ gather(sw2, 1)                      # partial over SF
        out = _MeshSum.apply(out, mesh, (model_dim,), 1.0, 1.0)
        return out.reshape(xb.shape), aux

    bentry = (tuple(batch_axes) if len(batch_axes) > 1 else
              batch_axes[0] if batch_axes else None)
    dd = "data" if fsdp else None
    specs = [(bentry, None, None),
             (None, None),                                       # router
             ("model", dd, None),
             ("model", dd, None),
             ("model", None, dd)]
    args = [x, p["router"], p["w1"], p["w3"], p["w2"]]
    if has_shared:
        specs += [(dd, "model"), (dd, "model"), ("model", dd)]
        args += [p["shared"]["w1"], p["shared"]["w3"], p["shared"]["w2"]]

    def grad_placements(spec):
        return tuple(Partial() if isinstance(pl, Replicate)
                     and a in partial_axes else pl
                     for a, pl in zip(names, logical.placements(spec, mesh)))

    fn = local_map(
        inner,
        out_placements=(logical.placements(specs[0], mesh),
                        logical.placements((), mesh)),
        in_placements=tuple(logical.placements(s, mesh) for s in specs),
        in_grad_placements=tuple(grad_placements(s) for s in specs),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)
