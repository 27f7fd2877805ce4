"""Shapes, optimizer settings and the launcher's train step — the one-card
part of the JAX package's ``launch/steps.py``.

``param_shapes`` builds the parameter tree on the ``meta`` device: shapes
and dtypes, nothing allocated (the reference's ``jax.eval_shape``).  The
reference's ``shard_logits`` / ``batch_axes`` options place the logits on a
device mesh; one card has no mesh, so they are left out.  The input and
cache specs and the prefill, decode and coded-serve steps belong to the
dry run, which is not ported yet (``ROADMAP.md`` A6).
"""
from __future__ import annotations

import math

import torch

from repro_torch.convert import tree_leaves
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


def make_train_step(cfg, opt_cfg, microbatch=0):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss),
    the forward remat'd; ``batch`` as ``train_lib.make_train_step`` takes
    it (tokens, and the context of a VLM or encoder-decoder plan).
    ``microbatch`` > 1 splits the global batch into that many
    gradient-accumulation slices, the gradients and the loss summed in fp32
    over them: live activations and fp32 logit temporaries shrink ~linearly
    at the cost of one forward per slice."""
    loss_fn = lm_loss_fn(cfg, remat=True)

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
