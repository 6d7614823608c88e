"""The disk cell on the card at a test size, and its control: run by
`python3 -m pytest benchmark/tests -m cuda` on a machine with a card; skipped
where torch sees none."""

from __future__ import annotations

import pytest

from benchmark.tests import cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_disk_on_the_card(card):
    code, line, err = cells.run("disk262k.gravity", seed=2**31 + 3, trace=1, seconds=1.0, device="cuda", n=16384)
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["k1_roofline"]["value"] <= 105


@pytest.mark.cuda
def test_control_on_the_card(card):
    code, line, err = cells.run("disk262k.gravity", seed=2**31 + 4, seconds=1.0, device="cuda", n=16384,
                                patch="benchmark.control:bf16_forces")
    assert code == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
