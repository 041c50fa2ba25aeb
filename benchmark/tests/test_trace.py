import os

import pytest

from benchmark.harness import trace
from benchmark.harness.trace import Trace, name_matcher

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trace_decode.xplane.pb")


@pytest.fixture(scope="module")
def recorded():
    return trace.load(FIXTURE)


def test_recorded_trace_finds_the_core(recorded):
    fwd = name_matcher(["viterbi_acs_forward"])
    tb = name_matcher(["viterbi_traceback"])
    assert list(recorded.devices) == [0]
    assert recorded.op_count(0, fwd) > 0 and recorded.op_count(0, tb) > 0
    # The recorded hard decode (B=2048 x T=2054, H100 at 400 W): the forward
    # ~530 us and the traceback ~147 us a call.
    per_fwd = recorded.op_ns(0, fwd) / recorded.op_count(0, fwd)
    per_tb = recorded.op_ns(0, tb) / recorded.op_count(0, tb)
    assert 400e3 < per_fwd < 700e3 and 100e3 < per_tb < 200e3
    assert 0 < recorded.mean_busy_s() / recorded.window_s <= 1
    assert 0 <= recorded.idle_share() < 1


def test_recorded_breakdown(recorded):
    ops = recorded.top_ops()
    assert ops[0][0] == "viterbi_acs_forward" and len(ops) <= 10
    gaps = recorded.idle_gaps()
    assert 0 < len(gaps) <= 10
    assert all(g[1] > 0 for g in gaps)
    assert gaps == sorted(gaps, key=lambda g: -g[1])


def test_busy_union_and_labels():
    tr = Trace({0: [("a", 0, 10), ("b", 5, 20), ("a", 30, 40)],
                1: [("c", 0, 50)]},
               [("bench.window", 0, 100), ("bench.wait", 20, 30),
                ("PjitFunction(f)", 22, 25)],
               (0, 100))
    assert tr.busy_intervals(0) == [[0, 20], [30, 40]]
    assert tr.busy_ns(0) == 30 and tr.busy_ns(1) == 50
    assert tr.mean_busy_s() == pytest.approx(40e-9)
    assert tr.idle_share() == pytest.approx(0.6)
    assert tr.op_ns(0, name_matcher(["a"])) == 20
    assert tr.idle_gaps(top=2) == [["bench.window/none", pytest.approx(60e-9)],
                                   ["bench.window/none", pytest.approx(50e-9)]]
    assert tr.host_label(23) == "bench.wait/PjitFunction(f)"


def test_window_clips_operations():
    tr = Trace({0: [("a", 0, 10), ("a", 95, 120)]}, [], (5, 100))
    assert tr.ops(0) == [("a", 5, 10), ("a", 95, 100)]


def test_name_matcher():
    m = name_matcher(["viterbi_acs_forward"])
    assert m("viterbi_acs_forward") and m("viterbi_acs_forward_1")
    assert not m("viterbi_acs_forwardx") and not m("viterbi_traceback")
