"""nbx_torch.parallel.spatial (the halo-exchange granular step on
torch.distributed) against nbx.parallel.spatial, on the scenes of
tests/test_spatial.py.

The port's step runs in gloo ranks, spawned once per mesh shape (a 1-D mesh
of 8, a 2x4 mesh, and one rank for the one-device scene), every scene inside
them (tests/torch_spatial_ranks.py). The JAX step runs in a worker
subprocess per mesh shape with its own 8 virtual CPU devices
(tests/torch_spatial_jax_worker.py), as tests/test_multihost.py runs its JAX
workers: the suite's own process has one device, where the JAX package's
tests/test_spatial.py skips. All of them start together and write npz files.

Held: the port's slots equal the JAX step's slot for slot after every step:
uid, partner_uid, mat, uid_next and every counter exactly; pos, vel, acc,
mass, temp and contact_t to 1e-5 of each field's largest magnitude (the bar
of tests/test_spatial.py:148-153; float32 sums in another order). Fractures
get each rank's uniforms of the JAX step's stream (fold_in(key, rank), then
_make_fragments' split), rebuilt here. Then each scene's own claims from
tests/test_spatial.py on the port's result, P3M against the JAX package's
p3m_acceleration at the JAX test's bar, and the chain the JAX step's
docstring claims: at zero-overflow caps on tie-free scenes the port's step
on 8 ranks equals the port's own granular_full_kdk_scan (held against nbx
in tests/test_torch_collisions_scaled.py)."""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from nbx_torch import convert
from nbx_torch.bench import spatial as spatial_bench
from nbx_torch.collisions_scaled import granular_full_kdk_scan, make_granular_state
from nbx_torch.config import f32
from torch_parity import assert_close
from torch_spatial_ranks import (BOX, COUNTERS, G8, KINDS, SCENES, SPATIAL_FIELDS, draws_key, fractures_on,
                                 port_config, scene_arrays)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DEADLINE_S = 600
EXACT = ("mat", "uid", "partner_uid")
FLOATS = ("pos", "vel", "acc", "mass", "temp", "contact_t")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_draws(key, cfg, rank: int) -> dict:
    """One rank's fracture uniforms of one JAX step: _make_fragments(fold_in(
    key, rank)) splits that key into k_count, k_scan (nbx/collisions.py:602)."""
    k_count, k_scan = jax.random.split(jax.random.fold_in(key, rank))
    f, k = cfg.max_fractures, cfg.max_fragments
    fold = jax.random.fold_in
    return dict(
        u0=jax.random.uniform(k_count, (f,)),
        u_mass=jax.random.uniform(fold(k_scan, 0), (k, f)),
        u_dir=jax.random.uniform(fold(k_scan, 1), (k, f, 3)),
        u_off=jax.random.uniform(fold(k_scan, 2), (k, f)),
        u_speed=jax.random.uniform(fold(k_scan, 3), (k, f)),
    )


def _write_draws(path: str) -> None:
    out = {}
    for name in SCENES:
        if not fractures_on(name):
            continue
        sc = SCENES[name]
        cfg = port_config(name)
        key = jax.random.PRNGKey(sc["key"])
        for i in range(sc["steps"]):
            for r in range(KINDS[sc["kind"]][0]):
                d = _rank_draws(jax.random.fold_in(key, i), cfg, r)
                out.update({f"{draws_key(name, i, r)}/{k}": np.asarray(v) for k, v in d.items()})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX workers and the port's ranks together; wait for all."""
    out = str(tmp_path_factory.mktemp("spatial"))
    _write_draws(os.path.join(out, "draws.npz"))
    procs = []
    jenv = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for kind in ("1d", "2d"):
        procs.append((f"jax {kind}", subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_spatial_jax_worker.py"), kind, out], env=jenv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tenv = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    for kind, (world, _) in KINDS.items():
        port = _free_port()
        for r in range(world):
            procs.append((f"rank {kind} {r}", subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_spatial_ranks.py"), kind, str(r), str(world), str(port),
                 out], env=tenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    deadline = time.time() + DEADLINE_S
    failed = []
    try:
        for what, p in procs:
            log, _ = p.communicate(timeout=max(5.0, deadline - time.time()))
            if p.returncode != 0:
                failed.append(f"{what} exited {p.returncode}:\n{log[-3000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n".join(failed)
    return out


def _load(out: str, name: str):
    """(port, jax): the port's ranks' slots joined in rank order, and the
    JAX step's, as dicts of numpy arrays keyed step/field."""
    kind = SCENES[name]["kind"]
    parts = [dict(np.load(os.path.join(out, kind, f"{name}_r{r}.npz"))) for r in range(KINDS[kind][0])]
    port = {}
    for k in parts[0]:
        if k.split("/")[-1] in SPATIAL_FIELDS:
            port[k] = np.concatenate([p[k] for p in parts])
        else:
            port[k] = parts[0][k]
            for p in parts[1:]:  # replicated: every rank holds the same
                np.testing.assert_array_equal(p[k], port[k], err_msg=k)
    return port, dict(np.load(os.path.join(out, kind, f"{name}_jax.npz")))


def _by_uid(st: dict, i: int) -> dict:
    """uid -> slot of the live slots after step i."""
    uid, mass = st[f"{i}/uid"], st[f"{i}/mass"]
    return {int(u): r for r, u in enumerate(uid) if u >= 0 and mass[r] > 0}


def _totals(st: dict, i: int):
    m, v = st[f"{i}/mass"], st[f"{i}/vel"]
    return float(m.sum()), (m[:, None] * v).sum(axis=0)


@pytest.mark.parametrize("name", [n for n, sc in SCENES.items() if sc["steps"] > 0])
def test_step_matches_jax_slot_for_slot(runs, name):
    port, want = _load(runs, name)
    for i in range(SCENES[name]["steps"] + 1):
        for f in EXACT + ("uid_next",):
            np.testing.assert_array_equal(port[f"{i}/{f}"], want[f"{i}/{f}"], err_msg=f"step {i} {f}")
        for f in FLOATS:
            assert_close(port[f"{i}/{f}"], want[f"{i}/{f}"], f"step {i} {f}")
        if i > 0:
            for k in COUNTERS:
                np.testing.assert_array_equal(port[f"{i}/c/{k}"], want[f"{i}/c/{k}"], err_msg=f"step {i} {k}")
    if "buckets" in want:
        np.testing.assert_array_equal(port["buckets"], want["buckets"])


@pytest.mark.parametrize("name", ["distribution", "distribution_2d"])
def test_state_distribution(runs, name):
    """spatial_state_for places each body in its slab's slots, as the JAX
    package does, exactly; dead input rows are dropped."""
    port, want = _load(runs, name)
    for f in SPATIAL_FIELDS + ("uid_next",):
        np.testing.assert_array_equal(port[f"0/{f}"], want[f"0/{f}"], err_msg=f)
    uid = port["0/uid"]
    assert (uid >= 0).sum() == (502 if name == "distribution" else 512)
    assert int(port["0/uid_next"]) == 512
    nl = uid.shape[0] // 8
    cell = BOX / G8
    d_x, d_y = (8, 1) if name == "distribution" else (2, 4)
    pos = port["0/pos"]
    for c in range(8):
        rows = np.nonzero(uid[c * nl:(c + 1) * nl] >= 0)[0] + c * nl
        cxy = np.clip((pos[rows, :2] / cell).astype(int), 0, G8 - 1)
        np.testing.assert_array_equal((cxy[:, 0] // (G8 // d_x)) * d_y + cxy[:, 1] // (G8 // d_y), c)
    pos0 = scene_arrays(name)[0]
    m = _by_uid(port, 0)
    for u in (0, 17, 501):
        np.testing.assert_array_equal(pos[m[u]], pos0[u])


def test_convert_round_trip(runs):
    """convert maps the JAX step's global slots to each rank's SpatialState
    and back, slot for slot (here the JAX state after the merge-rich
    scene's last step)."""
    _, want = _load(runs, "parity")
    arrays = {f: want[f"4/{f}"] for f in SPATIAL_FIELDS + ("uid_next",)}
    states = [convert.spatial_state_from_arrays(arrays, r, 8, device="cpu") for r in range(8)]
    assert all(st.pos.shape[0] == arrays["pos"].shape[0] // 8 for st in states)
    back = convert.spatial_state_to_arrays(*states)
    assert set(back) == set(arrays)
    for f, v in arrays.items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)
        assert back[f].dtype == v.dtype, f


def test_convert_ranks_draw_apart():
    """Each rank's converted state seeds its generator from (seed, rank), as
    spatial_state_for does, so the ranks' fracture uniforms differ."""
    nl, d = 4, 2
    arrays = {f: np.zeros((d * nl, 3) if f in ("pos", "vel", "acc") else (d * nl,), np.float32)
              for f in convert.SPATIAL_FIELDS}
    arrays["uid_next"] = np.asarray(0, np.int32)
    states = [convert.spatial_state_from_arrays(arrays, r, d, device="cpu", seed=3) for r in range(d)]
    draws = [torch.rand(8, generator=st.generator) for st in states]
    assert not torch.equal(draws[0], draws[1])
    again = convert.spatial_state_from_arrays(arrays, 1, d, device="cpu", seed=3)
    assert torch.equal(torch.rand(8, generator=again.generator), draws[1])


def _claims_parity(runs, name, port, want):
    c = {k: [int(port[f"{i}/c/{k}"]) for i in range(1, 5)] for k in COUNTERS}
    assert sum(c["n_bounces"]) > 0 and sum(c["n_merges"]) > 0
    assert sum(c["n_overflow"]) == sum(c["n_halo_over"]) == sum(c["n_dropped"]) == 0


def _claims_migration(runs, name, port, want):
    """Free streamers keep their uid and trajectory; ownership follows."""
    sc = SCENES[name]
    n_steps = sc["steps"]
    for i in range(1, n_steps + 1):
        assert int(port[f"{i}/c/n_dropped"]) == 0
    assert int(port[f"{n_steps}/c/in_transit"]) == 0
    pos0, vel0, _ = scene_arrays(name)
    rows = _by_uid(port, n_steps)
    assert len(rows) == len(pos0)
    got = np.asarray([port[f"{n_steps}/pos"][rows[u]] for u in range(len(pos0))])
    np.testing.assert_allclose(got, pos0 + vel0 * (sc["h"] * n_steps), rtol=1e-5, atol=1e-5)
    nl = port[f"{n_steps}/uid"].shape[0] // 8
    d_x, d_y = (8, 1) if name == "migration" else (2, 4)
    cxy = np.clip((got[:, :2] // (BOX / G8)).astype(int), 0, G8 - 1)
    own = (cxy[:, 0] // (G8 // d_x)) * d_y + cxy[:, 1] // (G8 // d_y)
    np.testing.assert_array_equal(np.asarray([rows[u] // nl for u in range(len(pos0))]), own)


def _claims_merge(runs, name, port, want):
    """One merge into the lower uid; mass and momentum conserved."""
    n_steps = SCENES[name]["steps"]
    assert sum(int(port[f"{i}/c/n_merges"]) for i in range(1, n_steps + 1)) == 1
    rows = _by_uid(port, n_steps)
    assert set(rows) == {0}
    m0, p0 = _totals(port, 0)
    m1, p1 = _totals(port, n_steps)
    assert m1 == pytest.approx(m0, rel=1e-6)
    np.testing.assert_allclose(p1, p0, rtol=1e-5, atol=1e-5)
    assert float(port[f"{n_steps}/mass"][rows[0]]) == pytest.approx(9.0)


def _claims_fracture(runs, name, port, want):
    """One fracture across the boundary: both parents die, fragments live
    with fresh uids, mass conserved."""
    n_steps = SCENES[name]["steps"]
    assert sum(int(port[f"{i}/c/n_fractures"]) for i in range(1, n_steps + 1)) == 1
    assert sum(int(port[f"{i}/c/n_dropped"]) for i in range(1, n_steps + 1)) == 0
    rows = _by_uid(port, n_steps)
    assert 0 not in rows and 1 not in rows and len(rows) >= 2 and min(rows) >= 2
    assert int(port[f"{n_steps}/uid_next"]) > 2
    assert _totals(port, n_steps)[0] == pytest.approx(_totals(port, 0)[0], rel=1e-5)


def _claims_caps(runs, name, port, want):
    """Starved caps are counted; waiting migrants are delayed, not lost."""
    waits = sum(int(port[f"{i}/c/n_mig_wait"]) for i in range(1, 4))
    halo_over = sum(int(port[f"{i}/c/n_halo_over"]) for i in range(1, 4))
    assert waits > 0 and halo_over > 0
    assert all(int(port[f"{i}/c/n_dropped"]) == 0 for i in range(1, 4))
    assert len(_by_uid(port, 3)) == 256


def _claims_bucketed(runs, name, port, want):
    """The bucketed local layout equals the packed one (the parity scene's
    first 3 steps): counters, and the state by uid."""
    packed, _ = _load(runs, "parity" if name == "bucketed" else "parity_2d")
    for i in range(1, 4):
        assert int(port[f"{i}/c/n_overflow"]) == 0 and int(port[f"{i}/c/n_dropped"]) == 0
        if name == "bucketed":
            for k in ("n_merges", "n_bounces", "n_overflow"):
                assert int(port[f"{i}/c/{k}"]) == int(packed[f"{i}/c/{k}"]), (i, k)
    if name == "bucketed":
        rb, rp = _by_uid(port, 3), _by_uid(packed, 3)
        assert set(rb) == set(rp)
        idx = sorted(rb)
        for f in ("pos", "vel", "mass", "temp", "contact_t"):
            np.testing.assert_allclose(port[f"3/{f}"][[rb[u] for u in idx]], packed[f"3/{f}"][[rp[u] for u in idx]],
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    else:
        assert _totals(port, 3)[0] == pytest.approx(_totals(port, 0)[0], rel=1e-6)


def _claims_p3m(runs, name, port, want):
    """h = 0: the step's acc is the P3M force at the input positions; it
    meets the JAX package's p3m_acceleration at the JAX test's bar."""
    assert int(port["1/c/n_overflow"]) == 0 and int(port["1/c/n_dropped"]) == 0
    assert int(port["1/c/in_transit"]) == 0 and int(want["p3m_unc"]) == 0
    acc_ref = want["p3m_acc"]
    m = _by_uid(port, 1)
    got = port["1/acc"][[m[u] for u in range(acc_ref.shape[0])]]
    scale = np.linalg.norm(acc_ref, axis=1).mean()
    np.testing.assert_allclose(got, acc_ref, rtol=2e-3, atol=2e-4 * scale)


CLAIMS = {
    "parity": _claims_parity, "parity_2d": _claims_parity,
    "migration": _claims_migration, "diagonal": _claims_migration,
    "merge": _claims_merge, "merge_2d": _claims_merge, "no_self_clones": _claims_merge,
    "fracture": _claims_fracture, "fracture_2d": _claims_fracture,
    "caps": _claims_caps,
    "bucketed": _claims_bucketed, "bucketed_2d": _claims_bucketed,
    "p3m": _claims_p3m, "p3m_2d": _claims_p3m,
}


@pytest.mark.parametrize("name", list(CLAIMS))
def test_scene_claims(runs, name):
    """tests/test_spatial.py's claims on each scene, on the port's result."""
    port, want = _load(runs, name)
    CLAIMS[name](runs, name, port, want)
    if name.startswith("merge_2d") or name.startswith("fracture_2d"):
        uid, nl = port["0/uid"], port["0/uid"].shape[0] // 8
        chips = {int(u): r // nl for r, u in enumerate(uid) if u >= 0}
        assert abs(chips[0] // 4 - chips[1] // 4) == 1 and abs(chips[0] % 4 - chips[1] % 4) == 1  # diagonal


def test_rejects_bad_config(runs):
    for r in range(8):
        got = dict(np.load(os.path.join(runs, "1d", f"bad_config_r{r}.npz")))
        assert "divide" in str(got["msg/divide"]) and "all-gather" in str(got["msg/all-gather"])


@pytest.mark.parametrize("name,force", [("parity", "zero"), ("parity_2d", "zero"), ("pm", "pm"), ("pm_2d", "pm")])
def test_step_equals_the_ports_single_device_scan(runs, name, force):
    """The chain: the port's spatial step on 8 ranks against the port's own
    granular_full_kdk_scan on the same scene (zero-overflow caps, tie-free):
    per-step counters exactly and the state by uid (pos, vel to 1e-5,
    contact_t exactly, partner uid = partner index) without gravity; with
    PM to the JAX test's 2e-4 (the density grid summed over ranks)."""
    sc = SCENES[name]
    port, _ = _load(runs, name)
    pos, vel, mass = scene_arrays(name)
    cfg = port_config(name)
    if force == "zero":  # the scan's step dt / sub_steps is the spatial step's h
        cfg = cfg.replace(sub_steps=1)
    assert f32(cfg.dt / cfg.sub_steps) == f32(sc["h"])
    st = make_granular_state(pos, vel, mass, seed=0, device="cpu")
    kw = dict(n_cells=G8, band_cells=sc["band"], packed_caps=sc["caps"], force_impl=force,
              pm_grid=sc.get("pm_grid", 128))
    if force == "zero":
        for i in range(1, sc["steps"] + 1):
            st, tot = granular_full_kdk_scan(st, cfg, BOX, 1, **kw)
            for k in ("n_merges", "n_bounces", "n_overflow"):
                assert int(tot[k]) == int(port[f"{i}/c/{k}"]), (i, k)
    else:
        st, _ = granular_full_kdk_scan(st, cfg, BOX, sc["steps"], **kw)
    n = sc["steps"]
    rows = _by_uid(port, n)
    idx = np.asarray(sorted(np.nonzero(st.mass.numpy() > 0)[0].tolist()))
    assert set(rows) == set(idx.tolist())
    sel = np.asarray([rows[int(u)] for u in idx])
    tols = dict(pos=1e-5, vel=1e-5, mass=1e-6, temp=1e-5) if force == "zero" else dict(pos=2e-4, vel=2e-4)
    for f, tol in tols.items():
        np.testing.assert_allclose(port[f"{n}/{f}"][sel], getattr(st, f).numpy()[idx], rtol=tol, atol=tol, err_msg=f)
    if force == "zero":
        np.testing.assert_array_equal(port[f"{n}/contact_t"][sel], st.contact_t.numpy()[idx])
        np.testing.assert_array_equal(port[f"{n}/mat"][sel], st.mat.numpy()[idx])
        np.testing.assert_array_equal(port[f"{n}/partner_uid"][sel], st.partner.numpy()[idx])


def test_bench_spatial_main_on_the_cpu():
    """`bench spatial`'s main at a small size on the CPU: both paths timed,
    the JAX bench's keys, the device named."""
    ref, rec = spatial_bench.main(1024, "8,2,64,96", "zero", steps=2, warmup=1, device="cpu")
    assert ref["path"] == "single_chip_scan" and rec["path"] == "spatial_halo_step"
    assert rec["d"] == 1 and rec["device"] == ref["device"] == "cpu"
    assert rec["ms_per_step"] > 0 and rec["overhead_vs_single"] > 0
    assert rec["n_overflow"] == 0 and rec["n_dropped"] == 0 and rec["in_transit"] == 0
    assert not torch.distributed.is_initialized()  # the bench's own world is gone


def test_bench_spatial_cli_raises_without_a_card(monkeypatch):
    from nbx_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["bench", "spatial", "1024"])
