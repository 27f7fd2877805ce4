"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--device cuda] [--steps 50] [--batch 8] [--seq 64] [--ckpt out.npz]

Trains the reduced config (``--full`` for the full one) on the synthetic
Markov LM stream, logs the loss, and optionally writes a checkpoint in the
JAX package's ``.npz`` layout (``checkpoint/io.save``).  Runs on the card
unless ``--device cpu``.  ``--microbatch`` is parsed and, as in the JAX
package's launcher, unused: every step is ``train_lib.make_train_step`` without
remat (gradient accumulation is ``launch.steps.make_train_step``).  A VLM's
batches carry stub patch embeddings (``cross_embeds`` [batch,
n_modality_tokens, d_model]) and an encoder-decoder's stub frame embeddings
(``frames`` [batch, seq, d_model]), 0.02 N(0, 1) drawn on the device from a
generator seeded by the step index, as the reference draws them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.io import save
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import resolve_device
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch.steps import n_params_of, param_shapes
from repro_torch.models import transformer as T
from repro_torch.training.optim import AdamConfig, adam_init
from repro_torch.training.train_lib import make_train_step


def _stub(device, step, shape):
    """Stub modality embeddings for one step: 0.02 N(0, 1) from a generator
    seeded by the step index."""
    gen = torch.Generator(device=device).manual_seed(step)
    return 0.02 * torch.randn(shape, generator=gen, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full config instead of the reduced one")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="parsed and unused, as in the reference launcher")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    print(f"arch={cfg.name} "
          f"params~{n_params_of(param_shapes(cfg)):,} on {dev}")
    params = T.init_params(cfg, 0, device=dev)
    opt_cfg = AdamConfig(lr=args.lr, grad_clip=1.0)
    opt_state = adam_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat=False)
    data = lm_batches(cfg.vocab, args.batch, args.seq, args.steps, seed=0)
    t0 = time.time()
    for i in range(args.steps):
        batch = {"tokens": torch.as_tensor(data[i][:, :args.seq],
                                           device=dev)}
        if cfg.family == "vlm":
            batch["cross_embeds"] = _stub(
                dev, i, (args.batch, cfg.n_modality_tokens, cfg.d_model))
        if cfg.enc_dec:
            batch["frames"] = _stub(dev, i, (args.batch, args.seq,
                                             cfg.d_model))
        params, opt_state, m = step(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)")
    if args.ckpt:
        save(args.ckpt, params, step=args.steps)     # leaves detached there
        print(f"checkpoint written to {args.ckpt}")
    return params


if __name__ == "__main__":
    main()
