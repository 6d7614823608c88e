"""What a cell is made of, found by name from `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The harness finds everything else by those names, so that a new cell or
metric is new files and new entries, never an edit:

  * the configuration: the JSON file its entry names (`file`), and beside it
    the module of the same stem (`benchmark/configs/<config>.py`), which
    sets the program up through its public entry points and judges a run
    against the plain reference;
  * the traffic mix: `benchmark/traffic/<traffic>.json`;
  * each metric, end to end or per layer: `benchmark/metrics/<name>.py`,
    whose `read(run)` returns the value or None where it finds nothing to
    read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    module: ModuleType  # the configuration's set-up and judge
    end_to_end: list  # [Metric]
    per_layer: list  # [Metric]


def _reports(entry: dict, cell: str, moved: set | None = None) -> bool:
    """Whether the cell reports a metric: it is listed in the metric's
    `workloads`, or the metric has none and (per layer) moves an end-to-end
    metric the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moved is None or entry["moves"] in moved


def _metric(entry: dict) -> Metric:
    path = HERE / "metrics" / f"{entry['name']}.py"
    return Metric(entry["name"], entry["unit"], load_module(path, f"benchmark_metric_{entry['name']}"))


def chips(name: str) -> int:
    """The chips the cell `name` asks for, from BENCHMARK.json alone."""
    return int({w["name"]: w for w in json.loads(BENCHMARK.read_text())["workloads"]}[name]["chips"])


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`), its files loaded."""
    bench = bench if bench is not None else json.loads(BENCHMARK.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_file = ROOT / configs[w["config"]]["file"]
    e2e = [_metric(m) for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m.name for m in e2e}
    per_layer = [_metric(m) for m in bench["per_layer"] if _reports(m, name, moved)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        config=json.loads(config_file.read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        module=load_module(config_file.with_suffix(".py"), f"benchmark_config_{w['config']}"),
        end_to_end=e2e, per_layer=per_layer,
    )
