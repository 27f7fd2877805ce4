"""Host-clock time of chip_smoke.py phase 8's full-width qwen2-0.5b decode
step (batch 4 at positions [918, 753, 657, 471] over a 1280-slot pool) and
of its 910-token prefill (batch 1), through the B7/B8 kernels on the card.

The port is imported from ``--src`` (default: this checkout's ``src``), so
two trees can be timed on one machine, one process each, alternating:

    python3 tools/lm_step_host.py [--src OTHER/src] [--rounds 10]

Each round times 20 decode steps and 5 prefills back to back, synchronized
at their ends (phase 8's measure); the JSON line printed gives every
round's mean per call and their median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

POS = [918, 753, 657, 471]
SEQ, PROMPT = 1280, 910


def per_call_ms(fn, iters, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T

    if not torch.cuda.is_available():
        raise SystemExit("lm_step_host needs a CUDA device")
    dev = "cuda"
    cfg = get_config("qwen2-0.5b")
    params = T.init_params(cfg, 0, device=dev)
    cache = T.init_cache(cfg, len(POS), SEQ, device=dev)
    tok = torch.zeros((len(POS), 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(POS, device=dev)
    prompt = torch.randint(0, cfg.vocab, (1, PROMPT), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))

    def decode():
        T.decode_step(cfg, params, cache, pos, token=tok)

    def prefill():
        T.prefill(cfg, params, tokens=prompt, cache_len=SEQ)

    dec, pre = [], []
    with torch.inference_mode():
        decode(), prefill()                            # build and warm up
        for _ in range(args.rounds):
            dec.append(per_call_ms(decode, 20, torch))
            pre.append(per_call_ms(prefill, 5, torch))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": args.src, "torch": torch.__version__,
        "card": card.strip().splitlines()[0] if card.strip() else None,
        "decode_step_host_ms": dec,
        "decode_step_host_ms_median": statistics.median(dec),
        "prefill_host_ms": pre,
        "prefill_host_ms_median": statistics.median(pre)}))


if __name__ == "__main__":
    main()
