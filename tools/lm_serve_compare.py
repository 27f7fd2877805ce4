"""Coded LM serving without a mesh, as ``chip_smoke.py`` phase 8 serves it,
timed in two trees of the port on one card.

    python3 tools/lm_serve_compare.py --src A/src --src B/src

Each tree runs in its own process, in the order A, B, B, A, so that the
card's drift over the call falls on both.  A process builds phase 8's
full-width qwen2-0.5b (bf16, random weights from seed 0) and its eight
prompts of 256-1024 tokens (seed 0), then serves them through
``deploy_lm`` (k=2, r=1, the sum scheme, 4 slots, a pool of 1280
positions, 16 new tokens, a 10 s deadline: no straggler) SERVES times,
each serve in a new session.  For every serve it prints the set-up
seconds (the session's construction, warm-up included), the serve's
seconds, the inter-token p50 and p99 ms, tokens per second, the B7 and
B8 launches of the set-up and of the serve, and the served tokens'
digest.  The last line is a JSON object
with every process's rows and the median of each number by tree.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOTS, SEQ, NEW, REQUESTS, SERVES = 4, 1280, 16, 8, 3


def child(src):
    sys.path.insert(0, str(Path(src).resolve()))
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import BatchingPolicy
    from repro_torch.serving.generation import GenerationSpec, deploy_lm

    cfg = get_config("qwen2-0.5b")
    params = T.init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(256, 1025, REQUESTS)]
    spec = GenerationSpec(
        cfg=cfg, params=params, k=2, r=1, scheme="sum",
        batching=BatchingPolicy(max_size=SLOTS), max_seq_len=SEQ,
        max_new_tokens=NEW, straggle_ms=10_000.0, device="cuda")

    def launches():
        c = ops.counters()
        return {n: c[n].value for n in ("flash_attention",
                                        "decode_attention")}
    rows = []
    for _ in range(SERVES):
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        with deploy_lm(spec, engine="threads") as sess:
            t1 = time.perf_counter()
            warm = launches()
            futs = [sess.submit(p) for p in prompts]
            if not sess.wait_all(timeout=300.0):
                raise AssertionError("unfinished requests")
            t2 = time.perf_counter()
            stats = sess.stats()
        after = launches()
        tokens = [f.result() for f in futs]
        rows.append({
            "setup_s": t1 - t0, "serve_s": t2 - t1,
            "p50_ms": stats.inter_token_p50_ms, "p99_ms": stats.p99_ms,
            "tokens_per_s": stats.tokens_per_s, "n": stats.n,
            "setup_launches": {n: warm[n] - before[n] for n in warm},
            "serve_launches": {n: after[n] - warm[n] for n in warm},
            "tokens_sha": hashlib.sha1(
                json.dumps(tokens).encode()).hexdigest()[:12]})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"rows": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (give two)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.src[0])
    if len(args.src) != 2:
        raise SystemExit("give --src twice: the two trees to compare")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    a, b = args.src
    by_tree = {a: [], b: []}
    for src in (a, b, b, a):
        print(f"--- {src}", flush=True)
        run = subprocess.run(
            [sys.executable, __file__, "--child", "--src", src],
            capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        if run.returncode:
            sys.stdout.write(run.stderr[-4000:])
            raise SystemExit(f"{src}: exit {run.returncode}")
        by_tree[src] += json.loads(run.stdout.strip().splitlines()[-1])[
            "rows"]
    medians = {src: {key: statistics.median(r[key] for r in rows)
                     for key in ("setup_s", "serve_s", "p50_ms", "p99_ms",
                                 "tokens_per_s")}
               for src, rows in by_tree.items()}
    print(json.dumps({"card": card.stdout.strip(), "median": medians,
                      "rows": by_tree}))


if __name__ == "__main__":
    main()
