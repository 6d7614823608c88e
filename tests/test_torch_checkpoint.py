"""The port's directory checkpoints (`checkpoint.save_state_dir` /
`load_state_dir`, `save_sharded` / `load_sharded`) in one process, as
tests/test_checkpoint.py holds the JAX package's three orbax checkpoints:
the single-state round trip and resume, a sharded full-physics state, and a
slab-owned SpatialState that resumes stepping identically. The multi-rank
cases (a checkpoint of four ranks re-sharded onto two and one) are in
tests/test_torch_multihost.py."""

import json
import os

import numpy as np
import pytest
import torch

from nbx_torch import checkpoint, scene, sim
from nbx_torch.config import SimConfig
from nbx_torch.parallel import shard, spatial

torch.set_num_threads(1)

STATE_FIELDS = ("pos", "vel", "acc", "mass", "temp", "mat", "alive", "seq", "next_seq", "step_count", "contact")


def _setup():
    """A 20-body galaxy with a head-on pair that fractures about frame 7, 5
    frames in (tests/test_torch_host_api.py's scene)."""
    sc = scene.reference_galaxy(n_disk=20, seed=1)
    pair = dict(pos=[[150, 0, 0], [158, 0, 0.3]], vel=[[20, 0, 0], [-20, 0, 0]], mass=[30.0, 30.0], mat=[0, 0],
                temp=[0.0, 0.0])
    sc = {k: np.concatenate([sc[k], np.asarray(v, sc[k].dtype)]) for k, v in pair.items()}
    cfg = SimConfig(capacity=48, fracture_threshold=5.0)
    st = scene.make_state(cfg, sc, "cpu", seed=7)
    for _ in range(5):
        st, _ = sim.step(st, cfg)
    return cfg, st


def _same_state(a, b):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_state_dir_roundtrip_bitwise(tmp_path):
    cfg, st = _setup()
    d = str(tmp_path / "ckpt")
    checkpoint.save_state_dir(d, st, cfg)
    m = json.load(open(os.path.join(d, checkpoint.MANIFEST)))
    assert m["kind"] == "SimState" and m["world_size"] == 1 and m["ranks"] == [[0, 48]] and m["n"] == 48
    st2, cfg2 = checkpoint.load_state_dir(d, "cpu")
    _same_state(st, st2)
    assert cfg2.replace(materials=None) == cfg.replace(materials=None)


def test_state_dir_resume_reproduces_the_trajectory(tmp_path):
    """Fractures included: the generator's state is in the rank's file."""
    cfg, st = _setup()
    d = str(tmp_path / "ckpt")
    checkpoint.save_state_dir(d, st, cfg)
    a, fractures = st, 0
    for _ in range(10):
        a, ev = sim.step(a, cfg)
        fractures += int(ev.n_fractures.sum())
    b, cfg2 = checkpoint.load_state_dir(d, "cpu")
    for _ in range(10):
        b, _ = sim.step(b, cfg2)
    assert fractures > 0
    _same_state(a, b)


def test_state_dir_refuses_another_kind(tmp_path):
    d = str(tmp_path / "ckpt")
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(1, device_type="cpu")
        checkpoint.save_sharded(d, shard.shard_state(mesh, np.zeros((8, 3), np.float32),
                                                     np.zeros((8, 3), np.float32), np.ones(8, np.float32)), mesh)
    with pytest.raises(ValueError, match="ShardedState"):
        checkpoint.load_state_dir(d, "cpu")


def test_sharded_body_state_roundtrip(tmp_path):
    """A mesh-sharded full-physics state checkpoints shard by shard and
    restores bitwise, its type kept (test_sharded_orbax_roundtrip)."""
    rng = np.random.default_rng(0)
    n = 64
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(1, device_type="cpu")
        st = shard.shard_body_state(mesh, rng.normal(0, 10, (n, 3)).astype(np.float32),
                                    rng.normal(0, 1, (n, 3)).astype(np.float32),
                                    rng.uniform(1, 5, n).astype(np.float32))
        st = st._replace(temp=st.temp + 3.0, partner=torch.arange(n, dtype=torch.int32).flip(0))
        d = str(tmp_path / "sharded")
        checkpoint.save_sharded(d, st, mesh)
        st2 = checkpoint.load_sharded(d, mesh)
    assert isinstance(st2, shard.ShardedBodyState)
    for f, a, b in zip(st._fields, st, st2):
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_spatial_state_roundtrip_and_resume(tmp_path):
    """The slab-owned SpatialState (persistent uids, the replicated uid_next,
    the rank's generator) restores bitwise and steps identically
    (test_spatial_orbax_roundtrip)."""
    rng = np.random.default_rng(1)
    n, g = 128, 8
    cfg = SimConfig()
    with shard.local_world("gloo"):
        mesh = shard.make_mesh(1, device_type="cpu")
        st = spatial.spatial_state_for(mesh, rng.uniform(10, 90, (n, 3)).astype(np.float32),
                                       rng.normal(0, 1, (n, 3)).astype(np.float32),
                                       rng.uniform(1, 5, n).astype(np.float32), 100.0, g, seed=5)
        d = str(tmp_path / "spatial")
        checkpoint.save_sharded(d, st, mesh)
        st2 = checkpoint.load_sharded(d, mesh)
        assert isinstance(st2, spatial.SpatialState)
        for f in ("pos", "vel", "acc", "mass", "mat", "temp", "uid", "partner_uid", "contact_t", "uid_next"):
            assert torch.equal(getattr(st, f), getattr(st2, f)), f
        assert torch.equal(st.generator.get_state(), st2.generator.get_state())
        step = spatial.make_spatial_granular_step(mesh, cfg, 100.0, g, 2, (64, 96), halo_cap=64, mig_cap=32,
                                                  force_impl="zero")
        a1, _ = step(st, 0.016)
        b1, _ = step(st2, 0.016)
    for f in ("pos", "vel", "uid", "partner_uid", "contact_t"):
        assert torch.equal(getattr(a1, f), getattr(b1, f)), f
