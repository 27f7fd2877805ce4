"""Train-step builders for the LM substrate: next-token training of a
deployed LM, parity distillation, and joint learned-encoder + parity
training — the JAX package's ``training/train_lib.py``.

Each builder returns ``step(params, opt_state, batch) -> (params, opt_state,
{"loss": tensor})``.  A step turns ``requires_grad`` on for the leaves it
trains (``convert.tree_leaves`` order), takes one ``torch.autograd.grad``
over them and applies ``training.optim.adam_update``, which writes the new
values into the parameter and moment tensors IN PLACE: clone a tree you want
to keep.  Teacher logits and member embeddings come in the batch, made by
the caller under ``torch.no_grad()`` (not ``inference_mode``: autograd
refuses to save inference tensors), so the deployed model is never trained.

The differentiated forward runs on ``cfg.replace(attn_backend="torch")``:
attention goes through the block scan's custom VJP
(``models.layers.flash_attention_xla``), as the JAX package differentiates
its "jnp" scan.  The flash kernel (B7) has no backward and
``kernels.ops.flash_attention_op`` raises when asked for a gradient; teacher
forwards under ``no_grad`` may still run it.

The next-token loss takes every layer plan: a VLM's batch carries its
patch embeddings as ``cross_embeds``, an encoder-decoder's its frame
embeddings as ``frames``, and both reach ``transformer.forward`` as the
reference's loss routes them.  The parity and joint steps pass no context,
as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.convert import as_tensor, tree_leaves
from repro_torch.models import transformer as T
from repro_torch.training.loss import lm_loss, parity_mse
from repro_torch.training.optim import AdamConfig, adam_init, adam_update


def grad_cfg(cfg):
    """``cfg`` with attention on the differentiable "torch" backend."""
    return cfg.replace(attn_backend="torch")


def value_and_grad(loss_fn, params, *args):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient w.r.t.
    every leaf of ``params`` (a list in ``tree_leaves`` order).  A leaf the
    loss does not reach (a cross-attention layer's unused ``norm``, as in
    the reference) gets zeros, as ``jax.grad`` gives it."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _step(loss_fn, opt_cfg):
    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = adam_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss}
    return step


def _context_kw(cfg, batch, device):
    """``forward``'s context argument from a batch, as the reference's loss
    routes it: {"cross_embeds": batch["cross_embeds"]} for a VLM,
    {"cross_embeds": batch["frames"]} for an encoder-decoder model, {} for
    the rest."""
    key = "frames" if cfg.enc_dec else \
        "cross_embeds" if cfg.family == "vlm" else None
    return {"cross_embeds": as_tensor(batch[key], device)} if key else {}


def lm_loss_fn(cfg, remat):
    """loss_fn(params, batch): the shifted next-token loss of
    ``batch["tokens"]`` [B, S], differentiable; ``batch`` also holds
    ``cross_embeds`` [B, n_ctx, D] (VLM) or ``frames`` [B, S_src, D]
    (encoder-decoder)."""
    fcfg = grad_cfg(cfg)

    def loss_fn(params, batch):
        logits, aux = T.forward(fcfg, params, tokens=batch["tokens"],
                                remat=remat, **_context_kw(
                                    cfg, batch, params["embed"].device))
        tokens = torch.as_tensor(batch["tokens"], device=logits.device)
        return lm_loss(logits, tokens, aux, cfg.router_aux_coef)
    return loss_fn


def make_train_step(cfg, opt_cfg: AdamConfig, remat=True):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    ``batch`` = {"tokens": [B, S] int} plus, per family,
    "cross_embeds": [B, n_modality_tokens, D] (vlm) or
    "frames": [B, S_src, D] (audio enc-dec)."""
    return _step(lm_loss_fn(cfg, remat), opt_cfg)


def _coeffs(coeffs, k, like):
    """Code coefficients as the reference promotes them against ``like``:
    float32 ones for None, else the given values (an int list stays int and
    takes ``like``'s dtype)."""
    c = torch.ones((k,), dtype=torch.float32, device=like.device) \
        if coeffs is None else as_tensor(coeffs, like.device)
    return c.to(torch.promote_types(c.dtype, like.dtype))


def parity_loss_fn(cfg, coeffs=None, remat=False):
    """loss_fn(params, batch): the parity distillation loss of
    ``make_parity_train_step``, differentiable.

    batch = {"embeds": [k, B, S, D] member-query embeddings,
             "teacher": [k, B, S, V] deployed-model logits}"""
    fcfg = grad_cfg(cfg)

    def loss_fn(params, batch):
        embeds, teacher = batch["embeds"], batch["teacher"]
        k = embeds.shape[0]
        c = _coeffs(coeffs, k, teacher)
        parity_q = torch.einsum("k,kbsd->bsd", c.to(embeds.dtype), embeds)
        target = torch.einsum("k,kbsv->bsv", c, teacher.to(c.dtype))
        out, aux = T.forward(fcfg, params, embeds=parity_q, remat=remat)
        return parity_mse(out, target) + cfg.router_aux_coef * aux
    return loss_fn


def make_parity_train_step(cfg, opt_cfg: AdamConfig, coeffs=None,
                           remat=False):
    """Parity-model training step for LM serving (paper §3.3 adapted to
    embedding-space queries).

    batch = {"embeds": [k, B, S, D] member-query embeddings,
             "teacher": [k, B, S, V] deployed-model logits}
    The parity model learns F_P(sum_i c_i emb_i) ~= sum_i c_i F(X_i)."""
    return _step(parity_loss_fn(cfg, coeffs, remat), opt_cfg)


def make_joint_parity_train_step(cfg, opt_cfg: AdamConfig, scheme,
                                 remat=False):
    """Joint encoder+parity training step: the learned scheme's encoder
    (``repro_torch.core.learned.LearnedScheme``) combines member-query
    embeddings and is trained together with the r parity LMs against the
    linear output code.

    params = {"enc": encoder params (a copy of ``scheme.enc_params``: they
              are updated in place),
              "parity": [transformer params] * scheme.r}
    batch  = {"embeds": [k, B, S, D], "teacher": [k, B, S, V]}

    After training, serve with ``scheme.with_params(params["enc"])``."""
    fcfg = grad_cfg(cfg)

    def loss_fn(params, batch):
        teacher = batch["teacher"]
        coeffs = scheme.coeffs.to(teacher.device)              # [r, k]
        enc_q = scheme.encode_with_params(
            params["enc"], batch["embeds"])                    # [r, B, S, D]
        target = torch.einsum("rk,kbsv->rbsv", coeffs,
                              teacher.to(coeffs.dtype))
        total = 0.0
        for j in range(scheme.r):
            out, aux = T.forward(fcfg, params["parity"][j], embeds=enc_q[j],
                                 remat=remat)
            total = total + parity_mse(out, target[j]) + \
                cfg.router_aux_coef * aux
        return total / scheme.r

    return _step(loss_fn, opt_cfg)


def init_train_state(cfg, key, opt_cfg: AdamConfig, *, device="cuda"):
    """Fresh parameters from ``key`` (an int seed or a ``torch.Generator``)
    and their Adam state."""
    params = T.init_params(cfg, key, device=device)
    return params, adam_init(params, opt_cfg)
