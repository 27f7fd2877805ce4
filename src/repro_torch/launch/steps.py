"""Step functions and meta-tensor input specs for every (architecture x
input-shape) pair: the JAX package's ``launch/steps.py``.

``param_shapes``, ``input_specs`` and ``cache_shapes`` build their trees on
the ``meta`` device: shapes and dtypes, nothing allocated (the reference's
``jax.eval_shape`` and ``ShapeDtypeStruct``).  The steps are plain
functions of the port's trees; under launcher rules
(``distributed.logical.logical_rules``) over a mesh they take DTensors, and
on one card (a mesh of one device, or none) plain tensors, where the
prefill, decode and coded-serve steps reach the CUDA kernels B7 and B8.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.convert import tree_leaves
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training.optim import AdamConfig, adam_update
from repro_torch.training.train_lib import lm_loss_fn, value_and_grad


def pick_opt_config(cfg, n_params):
    """bf16 Adam moments for >=30B-param archs (the reference's rule for
    its 16 GB chips), fp32 below."""
    mdt = "bfloat16" if n_params > 3e10 else "float32"
    return AdamConfig(lr=3e-4, weight_decay=0.1, moment_dtype=mdt)


def param_shapes(cfg, seed=0):
    """The parameter tree of ``cfg`` as meta tensors (no allocation)."""
    return T.init_params(cfg, seed, device="meta")


def n_params_of(shapes):
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(shapes))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape_name, dtype=None):
    """Meta-tensor stand-ins for every model input of this shape."""
    sh = SHAPES[shape_name]
    B, S = sh.global_batch, sh.seq_len
    dt = L._DTYPES[dtype or cfg.dtype]
    if sh.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if cfg.family == "vlm":
            batch["cross_embeds"] = _meta((B, cfg.n_modality_tokens,
                                           cfg.d_model), dt)
        if cfg.enc_dec:
            batch["frames"] = _meta((B, S, cfg.d_model), dt)
        return batch
    if sh.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}
    raise ValueError(sh.kind)


def cache_shapes(cfg, shape_name):
    sh = SHAPES[shape_name]
    return T.init_cache(cfg, sh.global_batch, sh.seq_len, device="meta")


def _context(cfg, batch):
    """The step's context argument, as the reference routes it."""
    if cfg.enc_dec:
        return {"cross_embeds": batch["frames"]}
    if cfg.family == "vlm":
        return {"cross_embeds": batch["cross_embeds"]}
    return {}


# --------------------------------------------------------------------------
def logits_pspec(batch_axes=("data",)):
    return (batch_axes, None, "model")


def make_train_step(cfg, opt_cfg, shard_logits=True, batch_axes=("data",),
                    microbatch=0):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss),
    the forward remat'd; ``batch`` as ``train_lib.make_train_step`` takes
    it (tokens, and the context of a VLM or encoder-decoder plan).
    ``shard_logits`` places the fp32 logits at ``logits_pspec(batch_axes)``
    on a mesh (vocab over ``model``; nothing without a mesh).
    ``microbatch`` > 1 splits the global batch into that many
    gradient-accumulation slices, the gradients and the loss summed in fp32
    over them: live activations and fp32 logit temporaries shrink ~linearly
    at the cost of one forward per slice."""
    loss_fn = lm_loss_fn(cfg, remat=True, logits_pspec=logits_pspec(
        batch_axes) if shard_logits else None)

    def train_step(params, opt_state, batch):
        if microbatch and microbatch > 1:
            m = microbatch
            n = len(batch["tokens"])
            if n % m:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{m} microbatches")
            leaves = tree_leaves(params)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(m):
                one = {key: x[i * n // m:(i + 1) * n // m]
                       for key, x in batch.items()}
                l_one, g_one = value_and_grad(loss_fn, params, one)
                for acc, g in zip(grads, g_one):
                    acc.add_(g.float() / m)
                loss = loss + l_one / m
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = adam_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss
    return train_step


def make_prefill_step(cfg):
    """prefill_step(params, batch) -> (last-token logits, cache)."""
    def prefill_step(params, batch):
        return T.prefill(cfg, params, tokens=batch["tokens"],
                         **_context(cfg, batch))
    return prefill_step


def make_decode_step(cfg, pos):
    """decode_step(params, cache, batch) -> (logits, cache) at ``pos`` (the
    cache written in place, as ``transformer.decode_step`` writes it)."""
    def decode_step(params, cache, batch):
        return T.decode_step(cfg, params, cache, pos, token=batch["token"])
    return decode_step


def make_coded_serve_step(cfg, k=2, optimized=False):
    """The paper's technique as one program (prefill flavour): embed k
    member query batches, encode (addition in embedding space, the ``sum``
    code), run the parity model, and return the parity output the decoder
    consumes.

    ``optimized=False`` — paper-faithful baseline: per-member embedding (as
    the frontend would embed each query) and the full parity logit
    sequence, of which the last position is returned.
    ``optimized=True``  — one gather over the [k*B, S] token block instead
    of k, and the unembed of only the position the LM decoder consumes (the
    last token): the [B, S, V] parity-logit matmul becomes [B, 1, V].

    A plan that cross-attends (VLM, encoder-decoder) needs a context the
    step does not take, and raises, as the reference's does."""
    def coded_step(parity_params, batch):
        toks = batch["tokens"]                  # [k, B, S]
        kk, B, S = toks.shape
        if optimized:
            flat = T.embed_tokens(cfg, parity_params,
                                  toks.reshape(kk * B, S))
            parity_q = flat.reshape(kk, B, S, -1).sum(0)
            logits, _ = T.forward(cfg, parity_params, embeds=parity_q,
                                  unembed_last_only=True)
            return logits, {}
        embeds = torch.stack([T.embed_tokens(cfg, parity_params, t)
                              for t in toks])   # [k, B, S, D]
        logits, _ = T.forward(cfg, parity_params, embeds=embeds.sum(0))
        return logits[:, -1:], {}
    return coded_step


def coded_input_specs(cfg, shape_name, k=2):
    sh = SHAPES[shape_name]
    return {"tokens": _meta((k, sh.global_batch, sh.seq_len), torch.int32)}
