"""The control at a size a test run holds: the reference computed in fp8
stands in the program's place and has to come out not correct under the
cells' limits, while the program (fp32 on the CPU here) is."""
import json
from pathlib import Path

import pytest

from portbench.tests.test_portbench_faults import BATCH, LOOP, MOE, TINY, \
    tiny_run

ROOT = Path(__file__).resolve().parents[2]


def limits(mix):
    return json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json")
                      .read_text())["limits"]


@pytest.mark.parametrize("cfg,traffic,mix", [
    (TINY, LOOP, "prefill-long-s16"), (TINY, BATCH, "decode-long-s24"),
    (dict(MOE, n_layers=16), LOOP, "prefill-long-s8")],
    ids=["dense-loop", "dense-batch", "moe-loop"])
def test_control_fails_the_limits_the_program_meets(cfg, traffic, mix):
    lim = limits(mix)
    correct, res = tiny_run(cfg, dict(traffic, limits=lim), control=True)
    assert correct, res.compared
    assert any(res.control[name] > lim[name] for name in lim), res.control
