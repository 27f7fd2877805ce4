"""Model step, MoE: the share of device time in the expert products of
``repro_torch.models.moe._experts``: the device operations launched by an
``aten::bmm`` inside that function (the model's only batched products;
its scatter, gather and SwiGLU elementwise work are not counted)."""

SPANS = {"moe_experts": ("repro_torch.models.moe", "_experts",
                         lambda *a, **k: None)}


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None

    def expert(o):
        return o.op == "aten::bmm" and any(k == "moe_experts"
                                           for k, _ in o.spans)
    t = tr.device_s(expert)
    return 100 * t / tr.device_s() if t else None
