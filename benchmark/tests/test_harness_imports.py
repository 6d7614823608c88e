"""No module under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared whole by their
top level: `nbx_torch` is not `nbx`."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark import spec
from benchmark.guard import FORBIDDEN

MODULES = sorted(spec.HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_finds_every_module():
    rel = {str(p.relative_to(spec.HERE)) for p in MODULES}
    assert {"run.py", "harness.py", "reference/gravity.py", "configs/disk262k.py", "metrics/k1_roofline.py"} <= rel


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}
    assert "nbx_torch" not in path.read_text()


def test_whole_names_are_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import nbx_torch.sim\nfrom nbx_torch import scene\nimport jaxtyping\n")
    assert not top_level_imports(f) & set(FORBIDDEN)
    f.write_text("import nbx.sim\n")
    assert top_level_imports(f) & set(FORBIDDEN) == {"nbx"}


def test_the_launcher_of_a_multi_card_cell_loads_no_torch():
    """The process that starts the ranks pays no torch import before them."""
    import subprocess
    import sys

    code = ("import sys, benchmark.run, benchmark.spec, benchmark.ranks, benchmark.guard;"
            "benchmark.spec.chips('merger1m_allgather.d4'); print('torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.stdout.strip() == "False", p.stderr
