"""End-to-end ParM serving driver on the port (twin of
``examples/serve_parm.py``): serve a small model with batched requests
through the coded frontend.

    PYTHONPATH=src python -m repro_torch.examples.serve_parm [--n 120] \
        [--k 2] [--m 4] [--batch-size 4] [--device cpu]

Trains a deployed classifier + parity model, declares the deployment once as
a ``DeploymentSpec`` and serves a request stream through
``deploy(spec, engine="threads")`` with an injected straggler instance,
reporting latency percentiles + how each prediction was completed
(model / parity-reconstruction), plus accuracy of each path.  The SAME spec
replays through the simulator: ``deploy(spec, engine="sim").replay(trace)``.
On the card the engine's encodes launch B1, its decodes B3, and a drain of
several recoverable groups B4.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.convert import resolve_device
from repro_torch.core.parity import train_parity_models
from repro_torch.data.pipeline import cluster_images
from repro_torch.examples.quickstart import train_classifier
from repro_torch.models.cnn import build
from repro_torch.serving.api import BatchingPolicy, DeploymentSpec, Trace, \
    deploy

IMG = (16, 16, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--straggle-ms", type=float, default=150.0)
    ap.add_argument("--batch-size", type=int, default=1,
                    help="adaptive-batching max batch size (main pool)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # train deployed + parity models ---------------------------------------
    x, y, tmpl = cluster_images(3000, noise=2.0, seed=0, image_shape=IMG)
    xt, yt, _ = cluster_images(args.n, noise=2.0, seed=1, templates=tmpl,
                               image_shape=IMG)
    params, fwd = train_classifier(x, y, dev)
    pp, scheme = train_parity_models(
        params, fwd, lambda s: build("mlp", s, image_shape=IMG,
                                     device=dev)[0],
        x, k=args.k, epochs=5, device=dev)

    # serve with an injected straggler --------------------------------------
    slow = {0}

    def delay(iid):
        return args.straggle_ms / 1e3 if iid in slow else 0.0

    spec = DeploymentSpec(
        fwd=fwd, params=params, parity_params=pp[0], strategy="parm",
        scheme=scheme, k=args.k, m=args.m, delay_fn=delay, device=str(dev),
        batching=BatchingPolicy(max_size=args.batch_size, max_delay_ms=2.0))
    out = {}
    with deploy(spec, engine="threads") as sess:
        t0 = time.perf_counter()
        futs = []
        for i in range(args.n):
            futs.append(sess.submit(xt[i:i + 1]))
            time.sleep(0.008)                  # ~125 qps arrival stream
        ok = sess.wait_all(timeout=120)
        wall = time.perf_counter() - t0
        if not ok:
            raise RuntimeError("unanswered queries!")
        stats = sess.stats()
        lat = np.array([f.latency_ms for f in futs])
        out.update(n=args.n, answered=sum(f.done() for f in futs),
                   wall_s=wall, completed_by=dict(stats["completed_by"]),
                   p50_ms=float(np.percentile(lat, 50)),
                   p90_ms=float(np.percentile(lat, 90)),
                   p99_ms=float(np.percentile(lat, 99)),
                   max_ms=float(lat.max()), accuracy={})
        print(f"\nserved {args.n} queries in {wall:.2f}s "
              f"(m={args.m} deployed + {max(1, args.m // args.k)} parity, "
              f"instance 0 straggles {args.straggle_ms:.0f} ms)")
        print(f"latency  p50={out['p50_ms']:.1f}ms "
              f"p90={out['p90_ms']:.1f}ms "
              f"p99={out['p99_ms']:.1f}ms max={out['max_ms']:.1f}ms")
        print(f"completed_by: {stats['completed_by']}")
        if stats["mean_batch_size"] > 1:
            print(f"adaptive batching: mean batch "
                  f"{stats['mean_batch_size']:.2f} over {stats['batches']} "
                  "inference calls")
        if stats["cancellations"]:
            print(f"redundant work cancelled: {stats['cancellations']} "
                  "queued items tombstoned")
        for how in ("model", "parity"):
            sel = [f for f in futs if f.completed_by == how]
            if sel:
                acc = float(np.mean([np.argmax(f.result()) == yt[f.qid]
                                     for f in sel]))
                out["accuracy"][how] = acc
                print(f"accuracy of '{how}' predictions: {acc:.3f} "
                      f"(n={len(sel)})")

    # the SAME spec replays through the simulator: the DES charges its
    # calibrated service-time model (not this tiny MLP's real latency), so
    # this is the 100k-query-scale view of the deployment just served
    sim = deploy(spec, engine="sim").replay(Trace(n_queries=20_000,
                                                  qps=125.0))
    out["sim_summary"] = sim.summary()
    print(f"\nsim replay of the same spec: {out['sim_summary']}")
    return out


if __name__ == "__main__":
    main()
