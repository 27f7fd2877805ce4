"""Device time of B4 (multigroup decode) kernel designs, side by side on one
card: the kernel of PRs 11-21 (v0) and the launch-parameter designs that led
to ``csrc/parity_kernels.cu:mg_decode_kernel`` (v2, v3, v7, v7s, v7t, v8;
each ``.cu`` file here says what it is), at G = 2 and G = 1000 groups of
k = 2 members, [G, 2, 1, 10] fp32, each checked against the plain formula
before it is timed, and an empty launch beside them.

    python3 tools/mg_decode_variants/run.py

Each variant builds with one ``nvcc`` (all in parallel) into
``build/mg_decode_variants/``; it is timed with torch.profiler over 200
back-to-back calls, three times in alternating order.  Prints one JSON line:
the card's name and power limit and every timing in microseconds.
"""
import ctypes
import json
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parent
OUT = HERE.parents[1] / "build" / "mg_decode_variants"
NAMES = ["v0", "v2", "v3", "v7", "v8", "v7s", "v7t"]


def nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")


def build(name):
    out = OUT / f"lib{name}.so"
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(out), str(HERE / f"{name}.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out))


def dev_us(fn, key, iters=200):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    tot = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and key in e.key)
    return tot / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(NAMES)) as ex:
        libs = dict(zip(NAMES, ex.map(build, NAMES)))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in libs.items():
        if name == "v0":
            lib.probe_mg0.argtypes = [P, P, P, P, I, I, LL, P]
        else:
            lib.probe_mg.argtypes = [P, P, P, P, P, I, I, LL, P]
        lib.probe_empty.argtypes = [P]
    dev = torch.device("cuda")
    s = torch.cuda.current_stream().cuda_stream
    k, n = 2, 10
    c = np.array([1.0, 2.0], np.float32)
    words = np.concatenate([c, np.float32(1) / c])
    res = {}
    for G in (2, 1000):
        g = torch.Generator(device="cuda").manual_seed(G)
        po = torch.randn((G, 1, n), generator=g, device=dev)
        outs = torch.randn((G, k, 1, n), generator=g, device=dev)
        idx = np.arange(G) % k
        sel = idx.astype(np.uint8)
        rows = np.concatenate([
            np.where(np.arange(k)[None] != idx[:, None], c, np.float32(0)),
            (np.float32(1) / c[idx])[:, None]], 1)
        cmat = torch.tensor(rows, device=dev)
        want = (po[:, 0] - (outs[:, :, 0] * cmat[:, :k, None]).sum(1)) \
            * cmat[:, k:]
        out = torch.empty_like(po)
        calls = {}
        for name, lib in libs.items():
            if name == "v0":
                calls[name] = (lambda lib=lib: lib.probe_mg0(
                    po.data_ptr(), outs.data_ptr(), cmat.data_ptr(),
                    out.data_ptr(), G, k, n, s), "mg_v0")
            elif name == "v7t" and G > 16:
                continue
            else:
                calls[name] = (lambda lib=lib: lib.probe_mg(
                    po.data_ptr(), outs.data_ptr(), words.ctypes.data,
                    sel.ctypes.data, out.data_ptr(), G, k, n, s),
                    "mg_" + name)
        calls["empty"] = (lambda: libs["v2"].probe_empty(s), "empty_kernel")
        for name, (fn, key) in calls.items():
            out.zero_()
            rc = fn()
            torch.cuda.synchronize()
            if name != "empty":
                err = float((out[:, 0] - want).abs().max())
                assert rc == 0 and err < 1e-5, (name, rc, err)
        for rnd in range(3):
            order = list(calls) if rnd % 2 == 0 else list(reversed(calls))
            for name in order:
                fn, key = calls[name]
                res.setdefault(f"G{G}", {}).setdefault(name, []).append(
                    round(dev_us(fn, key), 4))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "device_us": res}))


if __name__ == "__main__":
    main()
