"""Train a parity model for an assigned LM architecture (embedding-space
ParM) on the port and measure degraded-mode next-token agreement (twin of
``examples/train_parity_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_parity_lm \
        [--arch smollm-135m] [--device cpu]

1. "Deploy" a reduced LM trained briefly on a Markov stream.
2. Train a parity LM: F_P(sum embeddings) ~= sum logits  (MSE, §4.1).
3. Evaluate: for coding groups of k sequences, reconstruct one missing
   logit sequence via subtraction and report top-1 agreement with the
   deployed model's own prediction (the paper's A_d metric, LM flavour).

The teacher forwards run on the config's attention backend, which on the
card is B7 (its fp32 route for the reduced configs); the train steps
differentiate the block scan (``train_lib.grad_cfg``), since B7 has no
backward.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import resolve_device
from repro_torch.data.pipeline import lm_batches
from repro_torch.models import transformer as T
from repro_torch.training.optim import AdamConfig, adam_init
from repro_torch.training.train_lib import (make_parity_train_step,
                                            make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--parity-steps", type=int, default=60)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    B, S, k = 8, 32, args.k

    # 1. train the deployed LM ----------------------------------------------
    deployed = T.init_params(cfg, 0, device=dev)
    opt = AdamConfig(lr=3e-3)
    tstep = make_train_step(cfg, opt, remat=False)
    ostate = adam_init(deployed, opt)
    data = lm_batches(cfg.vocab, B, S, args.steps + 20, seed=0)
    losses = []
    for i in range(args.steps):
        deployed, ostate, m = tstep(
            deployed, ostate,
            {"tokens": torch.as_tensor(data[i][:, :S], device=dev)})
        losses.append(float(m["loss"]))
    print(f"deployed {args.arch} (reduced) loss after {args.steps} steps: "
          f"{losses[-1]:.3f}")

    # 2. train the parity LM -------------------------------------------------
    parity = T.init_params(cfg, 1, device=dev)
    pstep = make_parity_train_step(cfg, opt)
    pstate = adam_init(parity, opt)

    @torch.no_grad()
    def make_batch(toks):                      # toks [k, B, S]
        toks = torch.as_tensor(toks, device=dev)
        embeds = torch.stack([T.embed_tokens(cfg, deployed, t)
                              for t in toks])
        teacher = torch.stack([T.forward(cfg, deployed, tokens=t)[0]
                               for t in toks])
        return {"embeds": embeds, "teacher": teacher}

    mse = []
    for i in range(args.parity_steps):
        toks = np.stack([data[(i + j) % (args.steps + 20)][:B // k, :S]
                         for j in range(k)])
        parity, pstate, pm = pstep(parity, pstate, make_batch(toks))
        mse.append(float(pm["loss"]))
        if i % 20 == 0:
            print(f"  parity step {i}: mse={mse[-1]:.4f}")

    # 3. degraded-mode agreement --------------------------------------------
    batch = make_batch(np.stack([data[args.steps + j][:B // k, :S]
                                 for j in range(k)]))
    with torch.no_grad():
        f_p, _ = T.forward(cfg, parity, embeds=batch["embeds"].sum(0))
    teacher = batch["teacher"]
    agree = []
    for miss in range(k):
        avail = sum(teacher[j] for j in range(k) if j != miss)
        recon = f_p - avail
        agree.append(float(
            (recon.argmax(-1) == teacher[miss].argmax(-1)).float().mean()))
    rand = 1.0 / cfg.vocab
    print(f"degraded-mode top-1 agreement with deployed predictions "
          f"(k={k}): {np.mean(agree):.3f}  (random={rand:.4f})")
    return {"deployed_losses": losses, "parity_mse": mse,
            "agreement": float(np.mean(agree)), "random": rand}


if __name__ == "__main__":
    main()
