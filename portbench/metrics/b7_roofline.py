"""Kernels, B7 (prefill attention, ``kernels.ops.flash_attention_op``):
the least time the chip could take for the traced calls, over the device
time of the kernels they launched outside any aten op (the hand-written
kernel, not a copy that aligns an input).  Work per call from its shapes
(``harness/work.py``: 4 hd per kept causal pair and query head; q, k, v
and out once)."""
from portbench.harness import work


def describe(q, k, v, *, causal=True, window=0):
    B, Sq, H, hd = q.shape
    return {"B": B, "Sq": Sq, "Sk": k.shape[1], "H": H, "KV": k.shape[2],
            "hd": hd, "itemsize": q.element_size(), "causal": causal,
            "window": window, "dtype": str(q.dtype).split(".")[-1]}


SPANS = {"b7": ("repro_torch.kernels.ops", "flash_attention_op", describe)}


def read(run):
    tr = run.trace
    if tr is None:
        return None
    times = tr.span_kernel_s("b7")
    least = 0.0
    for call, t in times.items():
        d = tr.calls["b7"][call]
        if not d["causal"]:
            return None
        flops, nbytes = work.b7_work(d["B"], d["Sq"], d["Sk"], d["H"],
                                     d["KV"], d["hd"], d["itemsize"],
                                     d["window"])
        least += work.least_s(flops, nbytes, d["dtype"])
    total = sum(times.values())
    return 100 * least / total if total else None
