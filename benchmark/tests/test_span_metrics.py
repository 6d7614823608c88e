"""The readers of the program's spans: step_loop_host_ms, gravity_host_ms,
gather_host_ms and idle_in_step_share, on hand-built traces, on the traces
of the cells' programs run here on the CPU, and (`-m cuda`) on the card,
where the spans and the kernels must share one clock."""

from __future__ import annotations

import pytest
import torch

from benchmark import spec
from benchmark.harness import RunData, Setup
from benchmark.trace import WINDOW, Recorder, Trace

SPAN_METRICS = ("step_loop_host_ms", "gravity_host_ms", "gather_host_ms", "idle_in_step_share")


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py", f"t_{name}").read


def run_data(trace, steps_per_call=2, chips=1):
    return RunData(config={"n": 1024}, chips=chips, kind="cpu", setup_s=1.0, window_s=1.0, calls=40,
                   steps_per_call=steps_per_call, host_call_s=[0.001] * 40, call_s=[0.01] * 40,
                   traced=range(0, trace.calls if trace else 0), trace=trace)


def frame_trace() -> Trace:
    """Two calls of one frame (two substeps) each, in us: a device gap
    inside each frame's span and gaps outside both."""
    host = [(WINDOW, 0.0, 1000.0),
            ("nbx.step", 100.0, 300.0), ("nbx.substep", 110.0, 200.0), ("nbx.gravity", 120.0, 150.0),
            ("aten::mul", 125.0, 126.0), ("nbx.substep", 200.0, 290.0), ("nbx.gravity", 210.0, 230.0),
            ("nbx.events", 235.0, 240.0),
            ("nbx.step", 500.0, 700.0), ("nbx.substep", 510.0, 590.0), ("nbx.gravity", 520.0, 560.0),
            ("nbx.substep", 595.0, 690.0), ("nbx.gravity", 600.0, 610.0),
            ("cudaEventSynchronize", 720.0, 990.0)]
    device = [("k1", 0.0, 150.0), ("k1", 160.0, 450.0), ("add", 480.0, 520.0), ("k1", 650.0, 900.0)]
    return Trace(0.0, 1000.0, device, host, calls=2)


def sharded_trace() -> Trace:
    """One call of one sharded step: the gather, then the force."""
    host = [(WINDOW, 0.0, 1000.0), ("nbx.shard.step", 100.0, 400.0), ("nbx.gather", 110.0, 160.0),
            ("nbx.gravity", 170.0, 200.0)]
    device = [("ncclDevKernel_AllGather", 150.0, 170.0), ("k1", 180.0, 900.0)]
    return Trace(0.0, 1000.0, device, host, calls=1)


def test_frame_trace_by_hand():
    t = frame_trace()
    run = run_data(t)
    # the frames' spans, 400 us, less their forces' 100 us, over 2 calls x 2 steps
    assert reader("step_loop_host_ms")(run) == pytest.approx(1e-3 * 300.0 / 4)
    assert reader("gravity_host_ms")(run) == pytest.approx(1e-3 * 100.0 / 4)
    assert reader("gather_host_ms")(run) is None
    # idle: [150, 160] and [520, 650] inside the frames, [450, 480] and [900, 1000] outside
    assert reader("idle_in_step_share")(run) == pytest.approx(100.0 * 140.0 / 1000.0)
    assert reader("device_idle_share")(run) == pytest.approx(100.0 * 270.0 / 1000.0)


def test_sharded_trace_by_hand():
    run = run_data(sharded_trace(), steps_per_call=1, chips=4)
    assert reader("gather_host_ms")(run) == pytest.approx(1e-3 * 50.0)
    assert reader("gravity_host_ms")(run) == pytest.approx(1e-3 * 30.0)
    assert reader("step_loop_host_ms")(run) == pytest.approx(1e-3 * (300.0 - 80.0))
    # idle inside the step: [100, 150] before the gather's kernel, [170, 180] before K1's
    assert reader("idle_in_step_share")(run) == pytest.approx(100.0 * 60.0 / 1000.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read_gives_none(name):
    """No trace, a trace without the program's spans, a trace without device
    operations (the work ran inside the spans, on the host)."""
    t = frame_trace()
    no_spans = Trace(t.t0, t.t1, t.device, [h for h in t.host if not h[0].startswith("nbx.")], t.calls)
    no_device = Trace(t.t0, t.t1, [], t.host, t.calls)
    assert reader(name)(run_data(None)) is None
    assert reader(name)(run_data(no_spans)) is None
    assert reader(name)(run_data(no_device)) is None


@pytest.mark.parametrize("make", [frame_trace, sharded_trace])
def test_idle_in_step_is_part_of_device_idle(make):
    run = run_data(make())
    assert 0.0 < reader("idle_in_step_share")(run) <= reader("device_idle_share")(run)


def _program_trace(workload: str, n: int, device: torch.device, calls: int = 3, sync_each: bool = False):
    """The trace of `calls` calls of the cell's program at n bodies, set up
    and warmed as the harness does, under the harness's Recorder."""
    cell = spec.load_cell(workload)
    cell.config["n"] = n
    program = cell.module.setup(Setup(cell.config, cell.traffic, 2**31 + 5, device))
    state = program.call(program.state)
    recorder = Recorder(device)
    recorder.start()
    for _ in range(calls):
        state = program.call(state)
        if sync_each and device.type == "cuda":
            torch.cuda.synchronize(device)
    recorder.stop()
    return recorder.read(calls), program.steps_per_call


def test_cpu_traces_of_the_cells():
    """Both cells' programs on the CPU (the all-gather step at world size 1
    over gloo): their spans land inside the window, one outer span a step
    call; off the card the trace holds no device operation, so the readers
    give nothing, and a device operation laid over the window lets each
    read the real spans."""
    from nbx_torch.parallel import shard

    with shard.local_world("gloo"):
        for workload, outer, n in (("disk262k.gravity", "nbx.step", 256), ("merger1m_allgather.d4",
                                                                             "nbx.shard.step", 512)):
            t, steps = _program_trace(workload, n, torch.device("cpu"))
            names = [h[0] for h in t.host]
            assert names.count(outer) == 3 and names.count("nbx.gravity") == 3 * steps
            assert all(t.t0 <= s <= e <= t.t1 for name, s, e in t.host if name.startswith("nbx."))
            run = run_data(t, steps)
            assert all(reader(name)(run) is None for name in SPAN_METRICS)
            mid = (t.t0 + t.t1) / 2
            run = run_data(Trace(t.t0, t.t1, [("k", t.t0, mid)], t.host, t.calls), steps)
            values = {name: reader(name)(run) for name in SPAN_METRICS}
            assert (values["gather_host_ms"] is None) == (outer == "nbx.step"), values
            assert values["gravity_host_ms"] > 0 and values["step_loop_host_ms"] > 0
            assert 0.0 < values["idle_in_step_share"] <= reader("device_idle_share")(run)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_spans_and_kernels_share_one_clock(card):
    """The disk cell's program on the card, each call synchronised: every
    device operation of the window starts after its call's nbx.step span
    opens and before the next call's opens, and each call launches some."""
    t, _ = _program_trace("disk262k.gravity", 16384, torch.device("cuda", 0), calls=4, sync_each=True)
    opens = sorted(s for name, s, _ in t.host if name == "nbx.step") + [t.t1]
    assert len(opens) == 5
    for k in range(4):
        ops = [op for op in t.device if opens[k] <= op[1] < opens[k + 1]]
        assert ops, k
    assert all(op[1] >= opens[0] for op in t.device)
    run = run_data(t)
    assert 0 < reader("gravity_host_ms")(run) and 0 <= reader("idle_in_step_share")(run)
