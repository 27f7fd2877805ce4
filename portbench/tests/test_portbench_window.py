"""The window's arithmetic on hand-made timestamps."""
import math

from portbench.harness import window as W
from portbench.harness.traffic import Request


class Fut:
    def __init__(self, times, done=False):
        self._times = times
        self._done = done

    def done(self):
        return self._done

    @property
    def tokens_so_far(self):
        return list(range(len(self._times) - 1))


def req(t_submit, times, done=False):
    r = Request([1, 2, 3], 4, t_submit=t_submit)
    r.future = Fut(times, done)
    return r


def reqs():
    return [
        # admitted 1.0, tokens at 1.5 (first), 2.0, 2.5, 3.0 (last)
        req(0.9, [1.0, 1.5, 2.0, 2.5, 3.0], done=True),
        # submitted in the window, first token 2.4, next 3.2 (out)
        req(2.1, [2.2, 2.4, 3.2]),
        # submitted in the window, no token yet
        req(2.8, [2.9]),
        # submitted before the window
        req(0.5, [0.6, 0.7, 2.0]),
    ]


def test_tokens_per_s_counts_first_tokens_in_window():
    # window [1.2, 3.0): 1.5, 2.0, 2.5 | 2.4 | - | 2.0  -> 5 tokens
    assert W.tokens(reqs(), 1.2, 3.0) == 5
    assert math.isclose(W.tokens_per_s(reqs(), 1.2, 3.0), 5 / 1.8)


def test_ttft_counts_submissions_in_window_and_missing_as_infinite():
    v = W.ttft_ms(reqs(), 1.2, 3.0)
    assert sorted(v)[:1] == [300.00000000000017] or math.isclose(
        sorted(v)[0], 300.0)
    assert math.isinf(max(v)) and len(v) == 2
    assert math.isinf(W.percentile(v, 90))


def test_gaps_need_both_tokens_inside():
    g = sorted(W.gaps_ms(reqs(), 1.2, 3.0))
    # stream 1: 1.5->2.0, 2.0->2.5 (2.5->3.0 ends outside); stream 2: none
    # (3.2 outside); stream 4: 0.7->2.0 starts outside
    assert [round(x, 6) for x in g] == [500.0, 500.0]


def test_rounds_are_distinct_emit_times_after_first_tokens():
    # non-first emits in [1.2, 3.0): 2.0, 2.5, (3.2 out), 2.0 -> {2.0, 2.5}
    assert W.rounds(reqs(), 1.2, 3.0) == 2


def test_admission_and_events():
    assert [round(x, 6) for x in W.admission_ms(reqs(), 1.2, 3.0)] == [200.0]
    adm, fin = W.events(reqs(), 1.2, 3.0)
    assert adm == 2                    # admitted at 2.2 and 2.9
    assert fin == 0                    # the finished one ended at 3.0
    assert W.events(reqs(), 0.0, 3.1)[1] == 1


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert W.percentile(v, 90) == 90
    assert W.percentile(v, 95) == 95
    assert W.percentile([7.0], 95) == 7.0
    assert W.percentile([], 50) is None
    assert W.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 90) == 10
