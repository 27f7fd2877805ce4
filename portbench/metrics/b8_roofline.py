"""Kernels, B8 (decode attention, ``kernels.ops.decode_attention_op``):
the least time the chip could take for the traced calls, over the device
time of the kernels they launched outside any aten op.  Work per call
from its shapes and positions (``harness/work.py``: only the cache rows
each batch row's position admits, K and V once; q, out and pos once)."""
import torch

from portbench.harness import work


def describe(q, k_cache, v_cache, pos):
    B, H, hd = q.shape
    return {"B": B, "H": H, "hd": hd, "S": k_cache.shape[1],
            "KV": k_cache.shape[2], "itemsize": q.element_size(),
            "dtype": str(q.dtype).split(".")[-1], "pos": pos}


SPANS = {"b8": ("repro_torch.kernels.ops", "decode_attention_op", describe)}


def _positions(pos, B):
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().reshape(-1).tolist()
    elif not hasattr(pos, "__len__"):
        pos = [int(pos)]
    pos = [int(p) for p in pos]
    return pos * B if len(pos) == 1 else pos


def read(run):
    tr = run.trace
    if tr is None:
        return None
    times = tr.span_kernel_s("b8")
    least = 0.0
    for call, t in times.items():
        d = tr.calls["b8"][call]
        flops, nbytes = work.b8_work(_positions(d["pos"], d["B"]), d["S"],
                                     d["H"], d["KV"], d["hd"], d["itemsize"])
        least += work.least_s(flops, nbytes, d["dtype"])
    total = sum(times.values())
    return 100 * least / total if total else None
