"""The port's granular layout bench and collision-split harness
(nbx_torch.bench.granular, .collsplit, `python -m nbx_torch bench
granular|collsplit`) against nbx.bench.granular / .collsplit on the CPU: the
scenes and the config-token parser give the JAX package's arrays and tuples,
the mains run at a tiny N with device="cpu" and print the JAX keys, and the
CLI refuses to run without a card."""

import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nbx.bench import granular as jgranular
from nbx_torch import __main__ as cli
from nbx_torch.bench import collsplit, granular

torch.set_num_threads(1)

# the keys of one timed configuration's line of nbx.bench.granular.main
JAX_KEYS = {"n", "scene", "force", "box", "n_cells", "max_per_cell", "band_cells", "packed_caps",
            "max_blocks", "buckets", "windows", "construction", "ms_per_step", "n_overflow",
            "cell_too_small", "n_bounces", "n_merges", "n_fractures"}
# those of nbx.bench.collsplit.main
JAX_SPLIT_KEYS = {"n", "cfg", "box", "ms_sort", "ms_pass", "ms_full", "ms_layout_kernel_epilogue",
                  "ms_event_machinery"}


def _jax_parse(token):
    """The tuple nbx.bench.granular's parser builds for one token. The
    parser is inline in its _run_one; its loop is replayed from the source."""
    src = inspect.getsource(jgranular._run_one)
    loop = src[src.index("    cfgs = []\n"):src.index("    if not cfgs:")]
    ns = {}
    exec("def parse(argv):\n" + loop + "    return cfgs\n", ns)
    return ns["parse"](["1", "disk", "pm", token])[0]


@pytest.mark.parametrize("token", ["32,16", "32,16,4", "32,16,8,96,104", "40,16,8,u0.8", "40,16,8,u",
                                   "40,16,12,u0.7x4s", "40,16,12,u0.8x2g", "40,16,12,ug", "40,16,8,a0.99", "40,16,8,a",
                                   "40,16,8,c0.999", "40,16,8,c", "40,16,8,96,104,512"])
def test_config_tokens_give_the_jax_tuples(token):
    assert granular.parse_config(token) == _jax_parse(token)


@pytest.mark.parametrize("token", ["32,16,8,96", "32", "40,16,8,a0.99s", "40,16,8,u0.8sx4"])
def test_bad_config_tokens_exit(token):
    with pytest.raises(SystemExit):
        granular.parse_config(token)


def test_scenes_are_the_jax_benches():
    for a, b in zip(granular.debris_disk(99), jgranular.debris_disk(99)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(granular.granular_cloud(99, box=50.0), jgranular.granular_cloud(99, box=50.0)):
        np.testing.assert_array_equal(a, b)
    spec = importlib.util.spec_from_file_location(
        "granular_demo", Path(__file__).resolve().parent.parent / "examples" / "granular_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    for a, b in zip(granular.debris_disk(99, core_mass=2000.0), demo.debris_disk(99)):
        np.testing.assert_array_equal(a, b)
    st = granular.demo_state(100, device="cpu")
    assert float(st.temp[0]) == 1000.0 and float(st.mass[0]) == 2000.0


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_granular_main_on_the_cpu(capsys):
    """Every layout kind of the sweep at N = 256 on the disk: the JAX keys,
    the device named, the sized layouts' lines printed."""
    out = granular.main(256, "disk", "zero", "8,2", "8,16,4", "8,16,4,32,40", "8,16,4,u0.8x2", "8,16,4,a",
                        "8,16,4,c", "8,16,4,32,40,16", steps=2, device="cpu")
    lines = _lines(capsys)
    assert len(out) == 7
    for r in out:
        assert JAX_KEYS <= set(r) and r["device"] == "cpu" and r["ms_per_step"] > 0
    assert out[0]["band_cells"] is None and out[0]["n_overflow"] > 0  # full column, K = 2
    assert out[3]["windows"] == 2 and out[3]["buckets"] is not None
    assert out[6]["max_blocks"] == 16
    assert any(set(r) == {"buckets", "windows", "construction"} for r in lines)
    assert any(set(r) == {"layout"} for r in lines)
    assert sum(r["n_bounces"] for r in out) > 0


def test_granular_main_reports_rejected_configs(capsys):
    """A configuration the sizing helper rejects (uniform caps over the
    131,072-body disk's whole-column strips) is reported and skipped."""
    out = granular.main(131072, "disk", "zero", "8,16,8,a", steps=1, device="cpu")
    assert len(out) == 1 and "too peaked" in out[0]["rejected"]
    assert _lines(capsys) == out


def test_time_config_matches_the_scan():
    """time_config's totals are those of the timed scan."""
    pos, vel, mass, box = granular.scene_arrays(128, "cloud@40")
    st0 = granular.make_granular_state(pos, vel, mass, device="cpu")
    ms, totals = granular.time_config(st0, granular.bench_config(), 8, 16, 4, steps=2, warmup=1,
                                      force_impl="zero", box=box)
    _, want = granular.granular_full_kdk_scan(st0, granular.bench_config(), box, 2, n_cells=8, band_cells=4,
                                              force_impl="zero")
    assert ms > 0 and totals == {k: (bool(v) if v.dtype == torch.bool else int(v)) for k, v in want.items()}


def test_collsplit_main_on_the_cpu(capsys):
    out = collsplit.main(512, "cloudcd", "8,16,4,u0.8", "8,16,4,a0.99", steps=2, warmup=1, device="cpu")
    assert len(out) == 2 and len(_lines(capsys)) == 2
    for r in out:
        assert JAX_SPLIT_KEYS <= set(r) and r["device"] == "cpu"
        assert r["ms_sort"] > 0 and r["ms_pass"] > 0 and r["ms_full"] > 0


@pytest.mark.parametrize("which", ["granular", "collsplit"])
def test_cli_raises_without_a_card(monkeypatch, which):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", which, "256"])
