"""The metrics' arithmetic on synthetic runs and traces: step_ms,
step_p90_ms, host_call_ms, the idle union, K1's roofline and the
all-gather's device time."""

from __future__ import annotations

import pytest

from benchmark import counts, peaks, spec
from benchmark.harness import RunData
from benchmark.trace import WINDOW, Trace, parse

CARD = "NVIDIA H100 80GB HBM3"


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py", f"t_{name}").read


def run_data(**kw):
    base = dict(config={"n": 262144}, chips=1, kind=CARD,
                setup_s=4.0, window_s=10.0, calls=100, steps_per_call=2, host_call_s=[0.001] * 100,
                call_s=[0.1] * 100, traced=range(0), trace=None)
    base.update(kw)
    return RunData(**base)


def test_step_ms_is_the_window_over_its_steps():
    assert reader("step_ms")(run_data()) == pytest.approx(1e3 * 10.0 / 200)


def test_step_p90_ms():
    calls = [0.1] * 90 + [0.2] * 10  # calls of 2 steps
    got = reader("step_p90_ms")(run_data(call_s=calls))
    assert 50.0 <= got <= 100.0
    assert reader("step_p90_ms")(run_data(call_s=[0.1 * (k + 1) for k in range(11)])) == pytest.approx(500.0)


def test_host_call_ms_leaves_out_the_traced_calls():
    host = [0.001] * 100
    host[50:60] = [1.0] * 10
    assert reader("host_call_ms")(run_data(host_call_s=host, traced=range(50, 60))) == pytest.approx(1.0)


def test_idle_union_and_gaps():
    t = Trace(0.0, 100.0, [("k1", 0.0, 30.0), ("k2", 20.0, 55.0), ("k3", 70.0, 90.0)],
              [("aten::add", 48.0, 75.0), ("outer", 40.0, 95.0)], calls=1)
    assert t.busy() == [(0.0, 55.0), (70.0, 90.0)]
    assert t.busy_s == pytest.approx(75e-6)
    assert reader("device_idle_share")(run_data(trace=t)) == pytest.approx(25.0)
    assert t.idle_gaps() == [["aten::add", pytest.approx(15e-6)], ["outer", pytest.approx(10e-6)]]
    assert t.top_ops(2) == [["k2", pytest.approx(35e-6)], ["k1", pytest.approx(30e-6)]]


def test_parse_keeps_the_window_and_clips():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 90.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 160.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 120.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 101.0, "dur": 2.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 120.0},
    ]
    t = parse(events, calls=3)
    assert (t.t0, t.t1, t.calls) == (100.0, 150.0, 3)
    assert t.device == [("a", 100.0, 110.0), ("c", 120.0, 125.0)]
    assert [h[0] for h in t.host] == [WINDOW, "aten::mul"]


def test_k1_roofline_arithmetic():
    n = 262144
    bound = counts.direct_sum_ops(n) / peaks.H100_SXM["fp32"]
    assert counts.direct_sum_ops(n) == 26 * n * (n - 1) / 2
    assert bound == pytest.approx(13.3e-3, rel=0.01)
    ops = [("void pairwise_f32r_kernel<true>(...)", 0.0, 2 * bound * 1e6),
           ("void nbx_sum::combine_splits<3>(...)", 0.0, 0.0),
           ("other", 0.0, 1e6)]
    t = Trace(0.0, 1e7, ops, [], calls=1)
    assert reader("k1_roofline")(run_data(trace=t)) == pytest.approx(50.0)
    four = run_data(trace=t, chips=4, config={"n": 4 * n})
    per_rank = counts.direct_sum_ops(4 * n, 4) / peaks.H100_SXM["fp32"]
    assert reader("k1_roofline")(four) == pytest.approx(100.0 * per_rank / (2 * bound))
    assert reader("k1_roofline")(run_data(trace=Trace(0.0, 1.0, [], [], 1))) is None
    assert reader("k1_roofline")(run_data(trace=t, kind="cpu")) is None


def test_allgather_and_setup():
    ops = [("ncclDevKernel_AllGather_RING_LL(...)", 0.0, 300.0), ("AllGatherLike", 0.0, 1e3)]
    t = Trace(0.0, 1e4, ops, [], calls=3)
    assert reader("allgather_device_ms")(run_data(trace=t, steps_per_call=1)) == pytest.approx(0.1)
    assert reader("allgather_device_ms")(run_data()) is None
    assert reader("setup_s")(run_data()) == 4.0
