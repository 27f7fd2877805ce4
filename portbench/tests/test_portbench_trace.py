"""The trace reduction on hand-made profiler events: launches tied to
their thread and annotations, the busy union, and the readers built on
it."""
import pytest
import torch

from portbench.harness import trace as TR


class Ev:
    def __init__(self, name, start, dur, cpu=True, tid=0, corr=0, link=0,
                 annot=False):
        self._a = (name, start, dur, cpu, tid, corr, link, annot)

    def name(self):
        return self._a[0]

    def start_ns(self):
        return self._a[1]

    def duration_ns(self):
        return self._a[2]

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self._a[3] else \
            torch.autograd.DeviceType.CUDA

    def device_resource_id(self):
        return self._a[4]

    def correlation_id(self):
        return self._a[5]

    def linked_correlation_id(self):
        return self._a[6]

    def is_user_annotation(self):
        return self._a[7]


def events():
    return [
        Ev("portbench.trace", 0, 1000, tid=1, annot=True),
        # thread 7 (parity): a B8 call [100, 160] launching a kernel
        Ev("portbench.b8:4", 100, 60, tid=7, corr=50, annot=True),
        Ev("aten::empty_like", 105, 5, tid=7, corr=51),
        Ev("cudaLaunchKernelExC", 120, 10, tid=7, corr=900),
        Ev("decode_cluster_kernel", 200, 100, cpu=False, corr=900),
        # thread 8 (member): an aten::bmm launching a GEMM
        Ev("aten::bmm", 300, 50, tid=8, corr=60),
        Ev("cudaLaunchKernel", 310, 10, tid=8, corr=901),
        Ev("nvjet_gemm", 250, 150, cpu=False, corr=901, link=60),
        # a kernel running past the span is clipped
        Ev("cudaLaunchKernel", 900, 5, tid=8, corr=902),
        Ev("late_kernel", 950, 200, cpu=False, corr=902),
    ]


def test_reduce_ties_launches_to_threads_spans_and_ops():
    calls = {"b8": {4: {"B": 1}}}
    tr = TR.reduce_events(events(), calls, {7: "lm-parity-0",
                                            8: "lm-member-0"})
    ops = {o.name: o for o in tr.ops}
    assert ops["decode_cluster_kernel"].tid == 7
    assert ops["decode_cluster_kernel"].spans == (("b8", 4),)
    assert ops["decode_cluster_kernel"].op is None
    assert ops["nvjet_gemm"].op == "aten::bmm" and ops["nvjet_gemm"].tid == 8
    assert ops["late_kernel"].end == 1000
    # busy: [200, 400] and [950, 1000]
    assert tr.busy_s == 250e-9
    assert tr.window_s == 1000e-9
    assert tr.span_kernel_s("b8") == {4: 100e-9}
    assert tr.thread_of("lm-parity-0") == {7}
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["late_kernel", 50e-9] or \
        bd["device_ops"][0][0] == "nvjet_gemm"
    # the longest idle gap is [400, 950], ended by thread 8's launch
    assert bd["idle_gaps"][0][1] == 550e-9


def test_enclosing_handles_nested_annotations():
    annots = [(0, 100, ("step", 1)), (10, 20, ("b8", 2)),
              (30, 40, ("b8", 3))]
    got = TR._enclosing(annots, [(15, 0), (25, 1), (35, 2), (150, 3)])
    assert got == {0: (("step", 1), ("b8", 2)), 1: (("step", 1),),
                   2: (("step", 1), ("b8", 3))}


def test_readers_on_the_hand_made_trace():
    from portbench.harness import spec, work
    from portbench.harness.runner import RunView
    pos = torch.tensor([3, 0], dtype=torch.int32)
    calls = {"b8": {4: {"B": 2, "H": 4, "hd": 16, "S": 8, "KV": 2,
                        "itemsize": 2, "dtype": "bfloat16", "pos": pos}}}
    tr = TR.reduce_events(events(), calls, {7: "lm-parity-0"})
    run = RunView(None, {}, {}, [], 0.0, 1.0, tr)

    def read(name):
        return spec.metric_reader(name).read(run)
    assert read("device_idle_pct") == pytest.approx(75.0)
    assert read("parity_device_pct") == pytest.approx(100 / 3)
    flops, nbytes = work.b8_work([3, 0], 8, 4, 2, 16, 2)
    assert read("b8_roofline") == pytest.approx(100 * work.least_s(
        flops, nbytes, "bfloat16") / 100e-9)
    assert read("b7_roofline") is None
    assert read("moe_expert_pct") is None
