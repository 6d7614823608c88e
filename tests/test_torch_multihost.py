"""The port's multi-host entry (`nbx_torch.parallel.multihost`) and per-rank
checkpoints (`checkpoint.save_sharded` / `load_sharded`) on gloo ranks, as
tests/test_multihost.py holds the JAX package's on two coordinated CPU
processes.

Two worlds start together (tests/torch_multihost_ranks.py, spawned as
tests/test_torch_shard.py spawns its ranks): four ranks as two hosts of two
(LOCAL_RANK and GROUP_RANK set, as a launcher sets them) and two ranks. Each
rank places only its own rows, steps, reduces the energy, renders its rows
and saves its shard; it also renders its slab of a spatial scene and runs
the merger demo. Held here: the host-major mesh; the steps equal
`run_sharded` at D = 1 (to 1e-5 of each field's largest magnitude, the
float32 order of the gathered force sums) and the all-reduced energy is the
same bits on every rank; the four-rank checkpoint restores bitwise at D = 2
(in the two-rank world) and at D = 1 (here); the composited frames of
`render_sharded` and `render_spatial` equal the single-device splat of the
whole state (to 1e-5 of the largest value, the order of the composite's
sums); the merger demo writes its frames on rank 0 alone and refuses an N
that does not divide over the ranks; and `render_sharded` /
`render_spatial` at D = 1 are the single-device splat bit for bit."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nbx_torch import checkpoint
from nbx_torch.config import SimConfig
from nbx_torch.parallel import multihost, shard, spatial
from nbx_torch.render.colormap import tonemap
from nbx_torch.render.splat import splat_bodies_hdr
from torch_multihost_ranks import (EPS, SPATIAL_BOX, SPATIAL_CELLS, G, H, HT, N, STEPS, W, camera, scene,
                                   spatial_scene)
from torch_parity import FLOAT_TOL, assert_close

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIELDS = ("pos", "vel", "acc", "mass")
# case -> (world size, the GROUP_RANK and LOCAL_RANK of each rank)
WORLDS = {"d4": (4, [(0, 0), (0, 1), (1, 0), (1, 1)]), "d2": (2, [(0, 0), (1, 0)])}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost"))
    procs = []
    for case, (world, hosts) in WORLDS.items():
        port = _free_port()
        for r, (host, local) in enumerate(hosts):
            env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{TESTS}", PYTHONUNBUFFERED="1",
                       OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(r), LOCAL_RANK=str(local), GROUP_RANK=str(host))
            procs.append((f"{case} rank {r}", subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_multihost_ranks.py"), case, out], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    deadline = time.time() + 300
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
    return {case: [dict(np.load(os.path.join(out, f"{case}_r{r}.npz"))) for r in range(world)]
            for case, (world, _) in WORLDS.items()} | {"dir": out}


@pytest.fixture(scope="module")
def single():
    """run_sharded at D = 1 on the whole scene, its energy and frame."""
    pos, vel, mass = scene()
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(1, device_type="cpu")
        st = shard.shard_state(mesh, pos, vel, mass)
        st, _ = shard.run_sharded(st, shard.make_sharded_step(mesh), G, EPS, H, STEPS)
        ke, pe = shard.sharded_energy(mesh, st, G, EPS)
        img = shard.render_sharded(mesh, st, camera(), width=W, height=HT)
    return st, torch.stack([ke, pe]).numpy(), img


def _joined(ranks: list, prefix: str = "") -> dict:
    """The ranks' rows of each field joined in mesh order."""
    by_coord = sorted(ranks, key=lambda r: int(r["coord"]))
    return {f: np.concatenate([r[prefix + f] for r in by_coord]) for f in FIELDS}


@pytest.mark.parametrize("case", list(WORLDS))
def test_host_major_mesh(runs, case):
    world, _ = WORLDS[case]
    for r, out in enumerate(runs[case]):
        np.testing.assert_array_equal(out["mesh"], np.arange(world))
        assert int(out["coord"]) == r


def test_host_major_order_sorts_hosts_then_local_ranks():
    keys = [("a", 0), ("a", 1), ("b", 0), ("b", 1)]
    assert multihost.host_major_order(keys) == [0, 1, 2, 3]
    # ranks of one host numbered apart: the host's ranks are put together
    assert multihost.host_major_order([("a", 0), ("b", 0), ("a", 1), ("b", 1)]) == [0, 2, 1, 3]
    assert multihost.host_major_order([("a", 1), ("a", 0)]) == [1, 0]


@pytest.mark.parametrize("case", list(WORLDS))
def test_steps_match_run_sharded_at_d1(runs, single, case):
    st1, e1, _ = single
    got = _joined(runs[case])
    for f in FIELDS:
        assert_close(got[f], getattr(st1, f).numpy(), f"{case} {f}")
    energies = [out["energy"] for out in runs[case]]
    for e in energies[1:]:  # all-reduced: the same bits on every rank
        np.testing.assert_array_equal(e, energies[0])
    np.testing.assert_allclose(energies[0], e1, rtol=1e-5)


@pytest.mark.parametrize("case", list(WORLDS))
def test_render_sharded_composites_the_whole_state(runs, single, case):
    _, _, img1 = single
    for out in runs[case]:
        assert_close(out["img"], img1.numpy(), f"{case} frame", FLOAT_TOL)
    for out in runs[case][1:]:  # the composite is replicated
        np.testing.assert_array_equal(out["img"], runs[case][0]["img"])


def _spatial_splat(pos, mass, cam, cfg):
    """The single-device splat of the spatial scene's bodies, as render_spatial
    colours them (every body alive, rock, cold)."""
    from nbx_torch.config import body_radius

    pos, mass = torch.from_numpy(pos), torch.from_numpy(mass)
    mat, temp = torch.zeros(len(mass), dtype=torch.int32), torch.zeros(len(mass))
    mats = cfg.materials
    hdr = splat_bodies_hdr(pos, body_radius(mass, mat, mats), temp, mat, mass > 0, mats.color1, mats.color2, cam,
                           width=W, height=HT)
    return tonemap(hdr, 4.0)


@pytest.mark.parametrize("case", list(WORLDS))
def test_render_spatial_composites_the_whole_scene(runs, case):
    pos, _, mass, cam = spatial_scene()
    want = _spatial_splat(pos, mass, cam, SimConfig()).numpy()
    assert float(want.max()) > 0
    assert sum(int(out["n_spatial"]) for out in runs[case]) == N  # every body in one slab
    for out in runs[case]:
        assert_close(out["img_spatial"], want, f"{case} spatial frame", FLOAT_TOL)
    for out in runs[case][1:]:  # the composite is replicated
        np.testing.assert_array_equal(out["img_spatial"], runs[case][0]["img_spatial"])


@pytest.mark.parametrize("case", list(WORLDS))
def test_merger_demo_writes_on_rank_0_alone(runs, case):
    world, _ = WORLDS[case]
    lead, rest = runs[case][0], runs[case][1:]
    paths = [str(p) for p in lead["merger_paths"]]
    assert len(paths) == 1 and all(len(out["merger_paths"]) == 0 for out in rest)
    for p in paths:
        assert os.path.dirname(p) == os.path.join(runs["dir"], f"merger_{case}")
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert sorted(os.listdir(os.path.join(runs["dir"], f"merger_{case}"))) == sorted(map(os.path.basename, paths))
    for out in runs[case]:  # refused on every rank, before any collective
        assert str(out["merger_uneven"]) == f"N={N + 1} bodies do not divide over {world} ranks"
    assert not os.path.exists(os.path.join(runs["dir"], f"merger_{case}_uneven"))


def test_checkpoint_d4_restores_at_d2_and_d1_bitwise(runs):
    want = _joined(runs["d4"])
    for f in FIELDS:
        np.testing.assert_array_equal(_joined(runs["d2"], "from_d4_")[f], want[f], err_msg=f)
    back = checkpoint.load_sharded(os.path.join(runs["dir"], "ck_d4"), device="cpu")  # no mesh: D = 1
    assert isinstance(back, shard.ShardedState)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(), want[f], err_msg=f)
    back2 = checkpoint.load_sharded(os.path.join(runs["dir"], "ck_d2"), device="cpu")
    want2 = _joined(runs["d2"])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back2, f).numpy(), want2[f], err_msg=f)


def test_load_sharded_onto_a_mesh_of_one_and_the_format_gate(runs, tmp_path):
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(1, device_type="cpu")
        back = checkpoint.load_sharded(os.path.join(runs["dir"], "ck_d4"), mesh)
        assert back.pos.shape == (N, 3)
    with pytest.raises(ValueError, match="format"):
        p = tmp_path / "bad"
        p.mkdir()
        (p / checkpoint.MANIFEST).write_text('{"format_version": 99, "kind": "ShardedState"}')
        checkpoint.load_sharded(str(p), device="cpu")


def test_renders_at_d1_are_the_single_device_splat():
    """render_sharded and render_spatial in a world of one: the all_reduce is
    the identity, so each equals its single-device splat bit for bit."""
    pos, vel, mass = scene()
    cam = camera()
    cfg = SimConfig()
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(1, device_type="cpu")
        st = shard.shard_state(mesh, pos, vel, mass)
        got = shard.render_sharded(mesh, st, cam, width=W, height=HT)
        n = len(mass)
        mats = cfg.materials
        hdr = splat_bodies_hdr(st.pos, torch.pow(st.mass, 1.0 / 3.0) * 0.8, torch.zeros(n),
                               torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool), mats.color1,
                               mats.color2, cam, width=W, height=HT)
        assert torch.equal(got, tonemap(hdr, 4.0))
        spos, svel, smass, cam = spatial_scene()
        sst = spatial.spatial_state_for(mesh, spos, svel, smass, SPATIAL_BOX, SPATIAL_CELLS)
        got = spatial.render_spatial(mesh, sst, cfg, cam, width=W, height=HT)
        from nbx_torch.config import body_radius

        hdr = splat_bodies_hdr(sst.pos, body_radius(sst.mass, sst.mat, mats), sst.temp, sst.mat, sst.mass > 0,
                               mats.color1, mats.color2, cam, width=W, height=HT)
        assert torch.equal(got, tonemap(hdr, 4.0))
        assert float(got.max()) > 0


def test_initialize_needs_a_port_for_several_ranks(monkeypatch):
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_PORT"):
        multihost.initialize(world_size=2, rank=0, device="cpu")
