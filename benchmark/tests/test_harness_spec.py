"""BENCHMARK.json against its format rules (keys, names, units, counts and
lengths), and discovery by name: every cell's configuration, traffic mix and
metrics are files found from their names."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return json.loads(spec.BENCHMARK.read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names))
        for e in bench[section]:
            extra = set(e) - KEYS[section]
            assert not extra or (section in ("end_to_end", "per_layer") and extra == {"workloads"}), (section, e)
            assert KEYS[section] <= set(e)
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len(json.dumps(bench)) <= 64 * 1024


def test_command_paths_and_run_seconds(bench):
    assert bench["command"] == ["python3", "-m", "benchmark.run"]
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_configs_cells_and_metrics_entries(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


@pytest.mark.parametrize("workload", ["disk262k.gravity", "merger1m_allgather.d4"])
def test_cell_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == cell.config_name
    assert callable(cell.module.setup)
    assert cell.config["judged_calls"] >= 1
    assert {m.name for m in cell.end_to_end} == {"step_ms", "step_p90_ms", "setup_s"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)
    assert len(cell.per_layer) >= 1
    assert set(cell.config["limits"]) == {"start", "acc_in", "acc_gap", "dvel_gap"}


def test_a_new_cell_is_data_only(tmp_path):
    """A cell that BENCHMARK.json adds is found from its entry and files
    alone: here an entry pairing an existing configuration with an existing
    mix under a new name."""
    bench = json.loads(spec.BENCHMARK.read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="disk262k.again"))
    cell = spec.load_cell("disk262k.again", bench)
    assert cell.config_name == "disk262k" and cell.chips == 1


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no.such")
