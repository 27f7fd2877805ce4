"""The control and the program's readings, several seeds in one process
(not run by the benchmark's own runs):

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--quant fp8|router_bf16]

For each seed: a run of the cell as ``run.py`` makes it (a shorter window
where ``--seconds`` says so), then the comparison's numbers for the
program and for the control, the reference computed in fp8 (``quant="fp8"``
of ``harness/reference.py``) at the same positions.  One JSON line per
seed; the limits in the cell's traffic file are set from these readings
(``PERF.md``).  ``--quant router_bf16`` reads, in the control's place, the
witness of routing flips: the fp32 reference with only its router's input
rounded through bf16."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--quant", choices=("fp8", "router_bf16"),
                    default="fp8")
    args = ap.parse_args()
    import torch
    from portbench.harness import spec
    from portbench.harness.runner import run
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        res = run(cell, seed, args.seconds, False, "cuda:0", t0,
                  control=args.quant)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": {k: v[0] if isinstance(v, tuple) else v
                                      for k, v in res.compared.items()},
                          "quant": args.quant, "control": res.control,
                          "info": res.info,
                          "metrics": res.metrics,
                          "peak": res.device["memory_peak_bytes"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
