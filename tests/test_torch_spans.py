"""The port's spans (`nbx_torch.profiling.span`) on the CPU: nothing is built
without a profiler; under torch.profiler the frame step, the sharded step and
the at-scale granular scan export their spans as nested `user_annotation`
events; every span that `bench/profile_step.py` reads is opened somewhere in
the package, and PERF.md names every span the package opens."""

from __future__ import annotations

import ast
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from nbx_torch import profiling

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "nbx_torch"
# the package's modules that open spans: every one but the primitive's own
MODULES = sorted(p for p in PACKAGE.rglob("*.py") if p != PACKAGE / "profiling.py")


def _annotations(fn) -> list:
    """[(name, start, end)] of the `nbx.` user annotations of the Chrome
    trace that torch.profiler exports of fn() on the CPU, in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    events = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace
              if e.get("cat") == "user_annotation" and e.get("ph") == "X" and e["name"].startswith("nbx.")]
    return sorted(events, key=lambda x: x[1])


def _named(events, name) -> list:
    return [e for e in events if e[0] == name]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _children(events, parent, name) -> list:
    return [e for e in _named(events, name) if _inside(e, parent)]


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running, span and spanned build no record_function:
    span returns one shared no-op context, and a whole frame step runs."""
    from nbx_torch import scene, sim
    from nbx_torch.config import SimConfig

    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first, second = profiling.span("nbx.step"), profiling.span("nbx.gravity")
    assert first is second
    with first:
        pass
    assert profiling.spanned("nbx.test")(lambda x: x + 1)(1) == 2
    cfg = SimConfig(capacity=64, sub_steps=2, collisions=False)
    st = scene.make_state(cfg, scene.cold_collapse_disk(64), device="cpu")
    sim.step(st, cfg)


def test_chrome_trace_carries_the_spans(tmp_path):
    """profiling.trace() exports the spans as user annotations."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("nbx.step"):
            torch.ones(4).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "nbx.step" and e.get("cat") == "user_annotation" for e in events)


@pytest.mark.parametrize("collisions", [False, True])
def test_frame_step_spans_nest(collisions):
    """nbx.step > nbx.substep (one a substep) > {nbx.gravity, nbx.events},
    or nbx.collide in place of nbx.events with collisions on."""
    from nbx_torch import scene, sim
    from nbx_torch.config import SimConfig

    cfg = SimConfig(capacity=64, sub_steps=2, collisions=collisions)
    st = scene.make_state(cfg, scene.cold_collapse_disk(64), device="cpu")
    events = _annotations(lambda: sim.step(st, cfg))
    (frame,) = _named(events, "nbx.step")
    subs = _children(events, frame, "nbx.substep")
    assert len(subs) == cfg.sub_steps == len(_named(events, "nbx.substep"))
    resolver = "nbx.collide" if collisions else "nbx.events"
    absent = "nbx.events" if collisions else "nbx.collide"
    for sub in subs:
        assert len(_children(events, sub, "nbx.gravity")) == 1
        assert len(_children(events, sub, resolver)) == 1
    assert not _named(events, absent)


def test_sharded_step_spans_nest():
    """The all-gather step at world size 1 over gloo: nbx.shard.step >
    {nbx.gather, nbx.gravity}, the gather first."""
    from nbx_torch.parallel import shard

    rng = np.random.default_rng(0)
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    vel = np.zeros_like(pos)
    mass = np.ones(64, np.float32)
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(device_type="cpu")
        step = shard.make_sharded_step(mesh)
        st = shard.shard_state(mesh, pos, vel, mass)
        events = _annotations(lambda: step(st, 1.0, 0.1, 0.01))
    (outer,) = _named(events, "nbx.shard.step")
    (gather,) = _children(events, outer, "nbx.gather")
    (gravity,) = _children(events, outer, "nbx.gravity")
    assert gather[2] <= gravity[1]


def test_granular_scan_spans():
    """One step of the at-scale granular scan with PM gravity: the PM spans
    inside nbx.pm, and the collision pass's spans inside nbx.collide, all
    inside the step's nbx.substep."""
    from nbx_torch import collisions_scaled as cs
    from nbx_torch.bench.granular import granular_cloud
    from nbx_torch.config import SimConfig
    from nbx_torch.ops.collide import bucketed_layout_for

    box = 30.0
    pos, vel, mass = granular_cloud(512, seed=0, box=box)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.02, fracture_threshold=4.0)
    st = cs.make_granular_state(pos, vel, mass, seed=0, device="cpu")
    kw = dict(n_cells=8, band_cells=4, buckets=bucketed_layout_for(pos, box, 8, 4), force_impl="pm", pm_grid=16)
    events = _annotations(lambda: cs.granular_full_kdk_scan(st, cfg, box, 1, **kw))
    (sub,) = _named(events, "nbx.substep")
    (pm,) = _children(events, sub, "nbx.pm")
    for part in ("nbx.pm.deposit", "nbx.pm.solve", "nbx.pm.gather"):
        assert len(_children(events, pm, part)) == 1, part
    (resolver,) = _children(events, sub, "nbx.collide")
    (cpass,) = _children(events, resolver, "nbx.collide.pass")
    for part in ("nbx.collide.sort", "nbx.collide.windows", "nbx.collide.kernel", "nbx.collide.epilogue"):
        assert _children(events, cpass, part), part
    for part in ("nbx.collide.timers", "nbx.collide.fragments"):
        assert len(_children(events, resolver, part)) == 1, part


def _opened_spans() -> dict:
    """{span name: [files]} of every constant name the package passes to
    span() or spanned()."""
    found = {}
    for path in MODULES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) in ("span", "spanned")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                found.setdefault(node.args[0].value, []).append(path.name)
    return found


def test_profile_step_reads_spans_the_package_opens():
    from nbx_torch.bench import profile_step

    opened = _opened_spans()
    for parts in (profile_step.PARTS, profile_step.SPATIAL_PARTS, profile_step.SHARDED_PARTS):
        missing = set(parts) - set(opened)
        assert not missing, missing
    # no part reads another part's device time twice: each label comes from one span
    for parts in (profile_step.PARTS, profile_step.SPATIAL_PARTS, profile_step.SHARDED_PARTS):
        assert len(set(parts.values())) == len(parts)


def test_every_span_is_constant_and_documented():
    """Every span name the package opens is a constant `nbx.` name that
    PERF.md's table of spans names, beside what reads it."""
    opened = _opened_spans()
    assert {"nbx.step", "nbx.substep", "nbx.gravity", "nbx.events", "nbx.collide", "nbx.shard.step",
            "nbx.gather", "nbx.reduce_scatter"} <= set(opened)
    perf = (ROOT / "PERF.md").read_text()
    for name in opened:
        assert name.startswith("nbx.") and f"`{name}`" in perf, name
    calls = 0
    for path in MODULES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) in ("span", "spanned"):
                calls += 1
                assert node.args and isinstance(node.args[0], ast.Constant), (path.name, node.lineno)
    assert calls >= len(opened)
