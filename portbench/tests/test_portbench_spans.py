"""The readers of the program's own spans (``harness/spans.py``) on
hand-made profiler events: the device's idle time split by what the host
threads were doing, the scheduler's stalls clipped at the span's edges,
MoE dispatch, and None where the trace holds no such span."""
import pytest
import torch

from portbench.harness import spans as SP, spec, trace as TR
from portbench.harness.runner import RunView
from portbench.tests.test_portbench_trace import Ev, events

NEW = ("idle_launch_pct", "idle_sync_pct", "idle_sched_pct",
       "prefill_stall_pct", "rebuild_stall_pct", "moe_dispatch_pct")
# the device-trace readers the benchmark had before the program's spans
OLD = ("device_idle_pct", "parity_device_pct", "b7_roofline",
       "b8_roofline", "moe_expert_pct")


def served():
    """A span [0, 1000] with device work [200, 260] (launched by thread 7
    inside the benchmark's annotation of an MoE dispatch function) and
    [400, 420] (thread 8); member thread 7 in a job open at the profiler's
    start (its CPU events [20, 40]) and a decode job [100, 500] syncing over
    [300, 450]; parity thread 8 in a decode job [350, 600] syncing over
    [550, 600]; scheduler thread 9 admitting over [-100, 50] and
    [900, 1100] and rebuilding over [600, 700]."""
    return [
        Ev("portbench.trace", 0, 1000, tid=1, annot=True),
        Ev("aten::empty", 20, 20, tid=7, corr=10),
        Ev("repro_torch.lm.job.decode", 100, 400, tid=7, corr=11,
           annot=True),
        Ev("repro_torch.moe.dispatch", 140, 20, tid=7, corr=12, annot=True),
        Ev("portbench.moe_dispatch._scatter:3", 140, 20, tid=7, corr=13,
           annot=True),
        Ev("cudaLaunchKernel", 150, 5, tid=7, corr=900),
        Ev("indexing_backward_kernel", 200, 60, cpu=False, corr=900),
        Ev("repro_torch.lm.sync", 300, 150, tid=7, corr=14, annot=True),
        Ev("repro_torch.lm.job.decode", 350, 250, tid=8, corr=20,
           annot=True),
        Ev("cudaLaunchKernel", 380, 5, tid=8, corr=901),
        Ev("nvjet_gemm", 400, 20, cpu=False, corr=901),
        Ev("repro_torch.lm.sync", 550, 50, tid=8, corr=21, annot=True),
        Ev("repro_torch.lm.admit.prefill", -100, 150, tid=9, corr=30,
           annot=True),
        Ev("repro_torch.lm.admit.rebuild", 600, 100, tid=9, corr=31,
           annot=True),
        Ev("repro_torch.lm.admit.prefill", 900, 200, tid=9, corr=32,
           annot=True),
    ]


THREADS = {7: "lm-member-0", 8: "lm-parity-0", 9: "lm-scheduler"}


def view(evs, calls=None):
    tr = TR.reduce_events(evs, calls or {}, THREADS)
    return RunView(None, {}, {}, [], 0.0, 1.0, tr)


def read(name, run):
    return spec.metric_reader(name).read(run)


def test_the_idle_time_splits_by_what_the_host_was_doing():
    run = view(served())
    # idle [0, 200], [260, 400], [420, 1000]; launching (jobs without
    # their syncs, over threads) [20, 40], [100, 300], [350, 550]
    assert SP.idle(run.trace) == [(0, 200), (260, 400), (420, 1000)]
    assert read("idle_launch_pct", run) == pytest.approx(34.0)
    # syncing and no thread launching: [300, 350] and [550, 600]
    assert read("idle_sync_pct", run) == pytest.approx(10.0)
    # no job open: [0, 20], [40, 100], [600, 1000]
    assert read("idle_sched_pct", run) == pytest.approx(48.0)
    total = sum(read(n, run) for n in NEW[:3])
    assert total == pytest.approx(read("device_idle_pct", run), abs=1e-9)


def test_a_job_open_at_the_start_counts_from_its_events():
    run = view(served())
    assert SP.jobs(run.trace)[7] == [(20, 40), (100, 500)]
    # without its events thread 7's first stretch reads as the scheduler's
    bare = [e for e in served() if e.name() != "aten::empty"]
    assert read("idle_launch_pct", view(bare)) == pytest.approx(32.0)
    assert read("idle_sched_pct", view(bare)) == pytest.approx(50.0)


def test_stalls_are_clipped_at_the_span_edges():
    run = view(served())
    assert read("prefill_stall_pct", run) == pytest.approx(15.0)
    assert read("rebuild_stall_pct", run) == pytest.approx(10.0)


def test_moe_dispatch_counts_launches_inside_the_dispatch_functions():
    run = view(served())
    assert read("moe_dispatch_pct", run) == pytest.approx(75.0)
    mod = spec.metric_reader("moe_dispatch_pct")
    assert set(mod.SPANS) == {f"moe_dispatch.{f}" for f in mod.FUNCTIONS}


def test_none_where_the_trace_holds_no_program_span():
    plain = view([e for e in served()
                  if not e.name().startswith("repro_torch.")])
    for name in NEW:
        assert read(name, plain) is None, name
    assert read("device_idle_pct", plain) == pytest.approx(92.0)
    assert read(NEW[0], RunView(None, {}, {}, [], 0.0, 1.0, None)) is None


def test_existing_readers_read_the_same_with_program_spans():
    pos = torch.tensor([3, 0], dtype=torch.int32)
    calls = {"b8": {4: {"B": 2, "H": 4, "hd": 16, "S": 8, "KV": 2,
                        "itemsize": 2, "dtype": "bfloat16", "pos": pos}}}
    ours = [
        Ev("repro_torch.lm.job.decode", 90, 80, tid=7, corr=70, annot=True),
        Ev("repro_torch.lm.sync", 125, 40, tid=7, corr=71, annot=True),
        Ev("repro_torch.lm.job.prefill", 280, 100, tid=8, corr=72,
           annot=True),
        Ev("repro_torch.moe.dispatch", 290, 20, tid=8, corr=73, annot=True),
        Ev("repro_torch.lm.admit.prefill", 270, 120, tid=9, corr=74,
           annot=True),
    ]
    plain = view(events(), calls)
    spanned = view(events() + ours, calls)
    for name in OLD:
        assert read(name, spanned) == read(name, plain), name
    assert read("device_idle_pct", spanned) == pytest.approx(
        sum(read(n, spanned) for n in NEW[:3]), abs=1e-9)


@pytest.mark.parametrize("xs, ys, cut, both", [
    ([(0, 10)], [(2, 3), (5, 7)], [(0, 2), (3, 5), (7, 10)],
     [(2, 3), (5, 7)]),
    ([(0, 4), (6, 10)], [(3, 7)], [(0, 3), (7, 10)], [(3, 4), (6, 7)]),
    ([(0, 4)], [(4, 8)], [(0, 4)], []),
    ([(1, 2)], [(0, 5)], [], [(1, 2)]),
])
def test_interval_arithmetic(xs, ys, cut, both):
    assert SP.subtract(xs, ys) == cut
    assert SP.intersect(xs, ys) == both
    assert SP.length(SP.merge(xs + ys)) == SP.length(cut) + SP.length(ys)
