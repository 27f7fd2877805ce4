"""Host-clock time of the coded MLP path's encode (B1) and batched decode
(B4) on the card, and of one serve_parm run's encodes and decodes.

The port is imported from ``--src`` (default: this checkout's ``src``), so
two trees can be timed on one machine, one process each, alternating:

    python3 tools/coded_path_host.py [--src OTHER/src] [--rounds 10]

The calls are the same in every tree, with host values where a caller has
them (numpy coefficients and missing indices), at ``chip_smoke.py`` phase
2's shapes:

- ``op_encode``: ``ops.parity_encode_op`` on queries [2, 1, 784] fp32;
- ``scheme_encode``: ``LinearScheme.encode`` of ``sum`` (k=2, r=1) on them;
- ``op_decode``: ``ops.multigroup_decode_op`` of 1000 groups of [2, 1, 10];
- ``scheme_decode``: ``LinearScheme.decode_one_many`` on them.

Each round times 200 calls of each back to back, synchronized at their
ends; the JSON line printed gives every round's mean per call and their
median.  A torch.profiler trace of 50 more calls of each gives the device
operations one call issues (by kernel or copy name) and their device ms
per call, in all and in the kernel itself (B1's ``encode_kernel``, B4's
``mg_decode_kernel``).  Then ``repro_torch.examples.serve_parm.main([])``
serves its 120 queries with ``LinearScheme.encode``, ``decode_one`` and
``decode_one_many`` under host-clock timers (while the threads engine
serves, not while the models train): their calls, their summed host ms
and that sum's share of the serve's wall time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

CALLS = 200
G, K = 1000, 2


def per_call_ms(fn, iters, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_profile(fn, kernel, torch, iters=50):
    """(device operations per call by short name, device ms per call in
    all, device ms per call in ``kernel``) over ``iters`` calls of ``fn``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_op, total, own = {}, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.key.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0].strip()
        per_op[name] = per_op.get(name, 0) + ev.count / iters
        us = getattr(ev, "device_time_total", 0.0)
        total += us
        if kernel in ev.key:
            own += us
    return per_op, total / iters / 1e3, own / iters / 1e3


def timed_serve(scheme_cls, serve_parm):
    """One serve_parm run with the scheme's encode and decodes timed while
    the threads engine serves; returns its numbers."""
    spent = {"encode": [], "decode_one": [], "decode_one_many": []}
    lock = threading.Lock()
    active = [False]

    def timer(name, fn):
        def call(self, *args):
            if not active[0]:
                return fn(self, *args)
            t0 = time.perf_counter()
            try:
                return fn(self, *args)
            finally:
                with lock:
                    spent[name].append((time.perf_counter() - t0) * 1e3)
        return call

    deploy = serve_parm.deploy

    def deploy_timed(spec, engine="threads", **kw):
        active[0] = engine == "threads"
        return deploy(spec, engine=engine, **kw)

    originals = {name: getattr(scheme_cls, name) for name in spent}
    for name, fn in originals.items():
        setattr(scheme_cls, name, timer(name, fn))
    serve_parm.deploy = deploy_timed
    try:
        out = serve_parm.main([])
    finally:
        serve_parm.deploy = deploy
        for name, fn in originals.items():
            setattr(scheme_cls, name, fn)
    wall_ms = out["wall_s"] * 1e3
    coded_ms = sum(sum(v) for v in spent.values())
    return {"answered": out["answered"],
            "completed_by": out["completed_by"], "wall_ms": wall_ms,
            "calls": {name: len(v) for name, v in spent.items()},
            "host_ms": {name: sum(v) for name, v in spent.items()},
            "coded_share": coded_ms / wall_ms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from repro_torch.core.scheme import LinearScheme, get_scheme
    from repro_torch.examples import serve_parm
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise SystemExit("coded_path_host needs a CUDA device")
    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(0)
    q = torch.randn((K, 1, 784), generator=gen, device=dev)
    po = torch.randn((G, 1, 10), generator=gen, device=dev)
    outs = torch.randn((G, K, 1, 10), generator=gen, device=dev)
    c = np.ones(K, np.float32)
    idxs = np.arange(G) % K
    scheme = get_scheme("sum", k=K, device=dev)
    calls = {
        "op_encode": lambda: ops.parity_encode_op(q, c),
        "scheme_encode": lambda: scheme.encode(q),
        "op_decode": lambda: ops.multigroup_decode_op(po, outs, idxs, c),
        "scheme_decode": lambda: scheme.decode_one_many(po, outs, idxs),
    }
    kernels = {"op_encode": "encode_kernel", "scheme_encode": "encode_kernel",
               "op_decode": "mg_decode_kernel",
               "scheme_decode": "mg_decode_kernel"}
    times = {name: [] for name in calls}
    device = {}
    with torch.inference_mode():
        for fn in calls.values():                      # build and warm up
            fn()
        for _ in range(args.rounds):
            for name, fn in calls.items():
                times[name].append(per_call_ms(fn, CALLS, torch))
        for name, fn in calls.items():
            per_op, total, own = device_profile(fn, kernels[name], torch)
            device[f"{name}_device_ops"] = per_op
            device[f"{name}_device_ms"] = total
            device[f"{name}_kernel_device_ms"] = own
    serve = timed_serve(LinearScheme, serve_parm)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": args.src, "torch": torch.__version__,
        "card": card.strip().splitlines()[0] if card.strip() else None,
        **{f"{name}_host_ms": v for name, v in times.items()},
        **{f"{name}_host_ms_median": statistics.median(v)
           for name, v in times.items()},
        **device,
        "serve_parm": serve}))


if __name__ == "__main__":
    main()
