"""The benchmark's command:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on this machine's card and prints, as
the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, with
``--trace 1``, ``breakdown``; last in it, ``compared``: each number the
comparison read beside its limit.  The same numbers are the last lines of
its standard error.  It exits with another code than 0, printing no
result, where the card or the program is missing or a module of JAX or of
the JAX package was loaded."""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import guard, spec
    cell = spec.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    from portbench.harness.runner import run
    res = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
              T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    correct = all(v <= lim for v, lim in
                  (x for x in res.compared.values() if isinstance(x, tuple)))
    compared = {k: ({"value": v[0], "limit": v[1]} if isinstance(v, tuple)
                    else {"value": v}) for k, v in res.compared.items()}
    print(json.dumps({"run": res.info}), flush=True)
    out = {"correct": correct, "attempted": res.info["attempted"],
           "failed": res.info["failed"],
           "metrics": {name: {"value": value, "unit": _unit(cell, name)}
                       for name, value in res.metrics.items()},
           "device": res.device}
    if res.breakdown is not None:
        out["breakdown"] = res.breakdown
    out["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k}: {v['value']}"
              + (f" (limit {v['limit']})" if "limit" in v else ""),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _unit(cell, name):
    return next(m["unit"] for m in cell.end_to_end + cell.per_layer
                if m["name"] == name)


if __name__ == "__main__":
    sys.exit(main())
