"""Coded-serving launcher: ParM over an LM architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        [--device cuda] [--k 2] [--m 4] [--n 60] [--straggle-ms 120]

Trains a reduced deployed LM, distils a parity LM for it (embedding-space
addition code — the ``sum`` entry of the scheme registry), then serves
single-sequence queries through the declarative serving API
(``deploy(DeploymentSpec(...), engine="threads")``) with instance 0
straggling, and prints latency and completion-path statistics.
Degraded-mode predictions are the decoder's subtraction reconstructions.
``--strategy`` picks any registered ``ResilienceStrategy``;
``--batch-size`` enables adaptive batching on the main pool.  Runs on the
card unless ``--device cpu``.  On the card a query's forward runs the flash
kernel (B7), the parity query is encoded by B1 and a missing prediction is
rebuilt by B3.  Dense decoder stacks only.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import resolve_device, to_host
from repro_torch.data.pipeline import lm_batches
from repro_torch.models import transformer as T
from repro_torch.serving.api import BatchingPolicy, DeploymentSpec, deploy
from repro_torch.serving.strategy import available_strategies
from repro_torch.training.optim import AdamConfig, adam_init
from repro_torch.training.train_lib import (make_parity_train_step,
                                            make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--strategy", default="parm",
                    choices=available_strategies())
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="deadline for the default_slo strategy")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="adaptive-batching max batch size (main pool)")
    ap.add_argument("--batch-delay-ms", type=float, default=2.0,
                    help="max time a worker holds a batch open")
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--parity-steps", type=int, default=40)
    ap.add_argument("--straggle-ms", type=float, default=120.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full = get_config(args.arch)
    if full.enc_dec or full.family == "vlm":
        print("note: modality archs serve text-side queries here; frame/"
              "patch embeddings would ride along in production")
    cfg = get_config(args.arch, reduced=True)
    if cfg.enc_dec or cfg.family == "vlm":
        cfg = cfg.replace(enc_dec=False, n_enc_layers=0, cross_attn_every=0)
    B, S, k = 8, args.seq, args.k

    # 1. deployed LM
    deployed = T.init_params(cfg, 0, device=dev)
    opt = AdamConfig(lr=3e-3)
    tstep = make_train_step(cfg, opt, remat=False)
    ostate = adam_init(deployed, opt)
    data = lm_batches(cfg.vocab, B, S, args.train_steps + 40, seed=0)
    for i in range(args.train_steps):
        deployed, ostate, m = tstep(
            deployed, ostate,
            {"tokens": torch.as_tensor(data[i][:, :S], device=dev)})
    if args.train_steps:
        print(f"deployed {cfg.name}: loss {float(m['loss']):.3f}")

    # 2. parity LM (distillation); the teacher runs without a graph, on
    # cfg's own attention backend (the flash kernel on the card)
    parity = T.init_params(cfg, 1, device=dev)
    pstep = make_parity_train_step(cfg, opt)
    pstate = adam_init(parity, opt)

    @torch.no_grad()
    def make_batch(toks):                               # [k, B/k, S]
        toks = torch.as_tensor(toks, device=dev)
        embeds = torch.stack([T.embed_tokens(cfg, deployed, t)
                              for t in toks])
        teacher = torch.stack([T.forward(cfg, deployed, tokens=t)[0]
                               for t in toks])
        return {"embeds": embeds, "teacher": teacher}

    for i in range(args.parity_steps):
        toks = np.stack([data[(i + j) % len(data)][: B // k, :S]
                         for j in range(k)])
        parity, pstate, pm = pstep(parity, pstate, make_batch(toks))
    if args.parity_steps:
        print(f"parity model: final distill MSE {float(pm['loss']):.4f}")

    # 3. serve: queries are token sequences; the frontend encodes their
    # embeddings (float32 on the host: numpy has no bf16)
    def deployed_fwd(p, emb):
        emb = torch.as_tensor(emb, device=dev)
        return T.forward(cfg, p, embeds=emb)[0][:, -1]  # next-token logits

    def embed(tokens):
        with torch.no_grad():
            return to_host(T.embed_tokens(cfg, deployed, tokens))

    slow = {0}

    def delay(iid):
        return args.straggle_ms / 1e3 if iid in slow else 0.0

    extra = {}
    if args.strategy == "default_slo":
        # Clipper baseline: a constant (uniform-logits) default prediction
        # returned at the SLO deadline
        extra = dict(slo_ms=args.slo_ms,
                     default_prediction=np.zeros((1, cfg.vocab), np.float32))
    spec = DeploymentSpec(
        fwd=deployed_fwd, params=deployed, parity_params=parity,
        strategy=args.strategy, k=k, m=args.m, delay_fn=delay,
        batching=BatchingPolicy(max_size=args.batch_size,
                                max_delay_ms=args.batch_delay_ms),
        device=str(dev), **extra)
    with deploy(spec, engine="threads") as sess:
        rng = np.random.default_rng(0)
        futs = []
        for i in range(args.n):
            toks = data[rng.integers(len(data))][:1, :S]
            futs.append(sess.submit(embed(toks)))
            time.sleep(0.01)
        if not sess.wait_all(timeout=120):
            raise RuntimeError("unanswered queries")
        stats = sess.stats()
        lat = np.array([f.latency_ms for f in futs])
        fe = sess.frontend
        lay = fe.strategy.layout(args.m, k, fe.r)
        pools = f"main={lay.main}" + \
            (f" parity={lay.parity}x{fe.r}" if lay.parity else "")
        print(f"\nserved {args.n} queries via '{args.strategy}' "
              f"({pools}; instance 0 straggles {args.straggle_ms:.0f} ms)")
        print(f"latency p50={np.percentile(lat, 50):.1f}ms "
              f"p99={np.percentile(lat, 99):.1f}ms max={lat.max():.1f}ms")
        print(f"completed_by: {stats['completed_by']}")
        if stats["mean_batch_size"] > 1:
            print(f"batching: {stats['batches']} inference calls, "
                  f"mean batch {stats['mean_batch_size']:.2f}")
        if stats["cancellations"]:
            print(f"redundant work cancelled: "
                  f"{stats['cancelled_queries']} originals, "
                  f"{stats['cancelled_parities']} parity queries")
        recon = [f for f in futs if f.completed_by == "parity"]
        if recon:
            print(f"{len(recon)} predictions reconstructed from parity "
                  "outputs (degraded mode)")
    return futs, stats


if __name__ == "__main__":
    main()
