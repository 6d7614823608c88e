"""Whole runs of the benchmark's command on the CPU at test sizes (the
harness's look for a card skipped): the result line, and `correct` against
the control and against faults planted under the timed path.

The four-card cell runs as four processes over gloo, as on the card."""

from __future__ import annotations

import pytest

from benchmark.tests import cells

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", list(cells.SIZES))
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(workload, trace):
    code, line, err = cells.run(workload, seed=2**31 + 17, trace=trace)
    assert code == 0, err[-3000:]
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 40
    assert line["device"]["count"] == (4 if workload.endswith("d4") else 1)
    want = {"step_ms", "step_p90_ms", "setup_s"} if trace == 0 else {"host_call_ms", "device_idle_share"}
    assert set(line["metrics"]) == want  # the card's peaks and kernels are not on the CPU
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and set(line["breakdown"]) == {"device_ops",
                                                                                             "idle_gaps"}
    lines = err.strip().splitlines()
    assert [x.split()[1] for x in lines[-len(line["checks"]):]] == list(line["checks"])


FAULTS = {
    "disk262k.gravity": ["benchmark.control:bf16_forces", "benchmark.tests.faults:unchanged_state",
                         "benchmark.tests.faults:half_sources", "benchmark.tests.faults:altered_answer"],
    "merger1m_allgather.d4": ["benchmark.control:bf16_forces", "benchmark.tests.faults:unchanged_state",
                              "benchmark.tests.faults:half_sources", "benchmark.tests.faults:no_exchange",
                              "benchmark.tests.faults:altered_answer"],
}


@pytest.mark.parametrize("workload,patch", [(w, p) for w, ps in FAULTS.items() for p in ps],
                         ids=lambda x: x.split(":")[-1])
def test_control_and_faults_come_out_not_correct(workload, patch):
    code, line, err = cells.run(workload, seed=99, patch=patch)
    assert code == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", list(cells.SIZES))
def test_a_forbidden_module_after_the_window_gives_no_result(workload):
    """JAX loaded by the judge, after the window's own look: the run exits
    non-zero and prints no line, on one card and in each rank of four."""
    code, line, err = cells.run(workload, seed=7, patch="benchmark.tests.faults:forbidden_import_in_judge",
                                stdout=True)
    assert code != 0 and line == "", err[-3000:]
    assert "forbidden modules loaded" in err and "['jax']" in err


def test_no_card_no_result():
    """Without --device cpu the harness looks for a card; where torch sees
    none (or fewer than the cell needs), it exits non-zero and prints
    nothing."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "disk262k.gravity", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ but not the program."""
    import shutil
    import subprocess
    import sys

    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "disk262k.gravity", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "nbx_torch" in p.stderr
