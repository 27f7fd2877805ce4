"""Model step, MoE: the share of device time launched inside the
program's ``repro_torch.moe.dispatch`` spans (routing with its capacity
scan, the scatter of tokens into the expert buffers, the gather back), over
all device time (``moe_expert_pct``'s denominator).

The trace ties a device operation to the annotations around its launch
only for the benchmark's own (``portbench.<key>:<call>``), so this reader
annotates the functions of ``repro_torch.models.moe`` whose whole body is
such a span (those the program has) and counts the operations launched
inside them.  None where the trace holds no ``repro_torch.moe.dispatch``
span (a dense model, or a program without the span)."""
import importlib

from portbench.harness import spans

MODULE = "repro_torch.models.moe"
FUNCTIONS = ("route", "_scatter", "_gather", "_route_local")
SPAN = "repro_torch.moe.dispatch"


def _spans():
    try:
        moe = importlib.import_module(MODULE)
    except ImportError:
        return {}
    return {f"moe_dispatch.{f}": (MODULE, f, lambda *a, **k: None)
            for f in FUNCTIONS if hasattr(moe, f)}


SPANS = _spans()


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not spans.has(tr, lambda n: n == SPAN):
        return None

    def dispatch(o):
        return any(k.startswith("moe_dispatch.") for k, _ in o.spans)
    return 100 * tr.device_s(dispatch) / tr.device_s()
