"""The port's CUDA kernel on the card: held against its plain PyTorch version,
and the frame step on the card against the same step on the CPU.

Marked `cuda`: every test skips where torch sees no CUDA device. On a
machine with a card (nvcc on PATH or under CUDA_HOME; no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from nbx_torch import scene, sim
from nbx_torch.collisions import draw_fracture_uniforms
from nbx_torch.config import SimConfig
from nbx_torch.ops import pairwise

pytestmark = pytest.mark.cuda

TOL = 1e-5  # max|kernel - plain| / max|plain|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(n, seed, dev):
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.normal(size=(n, 3)) * 20, dtype=torch.float32, device=dev)
    mass = torch.tensor(rng.uniform(0.5, 5, n), dtype=torch.float32, device=dev)
    return pos, mass


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("nt,ns", [(4096, 4096), (1000, 4096), (777, 3001), (1, 300), (257, 255)])
def test_kernel_matches_plain(dev, nt, ns):
    pos, mass = _rand(ns, ns, dev)
    tgt, _ = _rand(nt, nt + 1, dev)
    before = pairwise.pairwise_acc.launches
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, tgt)
    assert pairwise.pairwise_acc.launches == before + 1
    want = pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, tgt)
    assert _rel_err(got, want) < TOL


def test_kernel_mass_zero_padding_is_inert(dev):
    pos, mass = _rand(3000, 7, dev)
    padded = mass.clone()
    padded[1500:] = 0.0
    got = pairwise.pairwise_acc(pos, padded, 0.5, 0.5)[:1500]
    want = pairwise.pairwise_acc_reference(pos[:1500], mass[:1500], 0.5, 0.5)
    assert _rel_err(got, want) < TOL


def test_kernel_wrapper_rejects_bad_inputs(dev):
    pos, mass = _rand(64, 8, dev)
    with pytest.raises(TypeError):
        pairwise.pairwise_acc(pos.double(), mass.double(), 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass.cpu(), 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass[:10], 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass, 0.5, 0.0)


def test_gravity_above_dense_max_uses_the_kernel(dev):
    pos, mass = _rand(2304, 9, dev)
    before = pairwise.pairwise_acc.launches
    got = sim.gravity(pos, mass, 0.5, 0.5)
    assert pairwise.pairwise_acc.launches == before + 1
    want = sim.gravity(pos.cpu(), mass.cpu(), 0.5, 0.5)  # row-blocked on the CPU
    assert _rel_err(got.cpu(), want) < TOL


def test_frames_on_card_match_cpu(dev):
    """Full physics above the dense limit: the card (kernel) and the CPU
    (blocked) take the same events and slots, with the same draws."""
    cfg_cpu = SimConfig(capacity=2304)
    cfg = cfg_cpu.to(dev)
    sc = scene.reference_galaxy(n_disk=2100, seed=1)
    a, b = scene.make_state(cfg, sc, dev), scene.make_state(cfg_cpu, sc)
    h = sim.substep_size(cfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(4 * cfg.sub_steps):
        d = draw_fracture_uniforms(cfg_cpu, gen, "cpu")
        a, ea = sim.substep(a, cfg, h, draws=d.to(dev))
        b, eb = sim.substep(b, cfg_cpu, h, draws=d)
        for f in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
            assert int(getattr(ea, f)) == int(getattr(eb, f)), f
    assert torch.equal(a.alive.cpu(), b.alive) and torch.equal(a.seq.cpu(), b.seq)
    for f in ("pos", "vel", "temp"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), f


def test_step_makes_no_host_sync(dev):
    cfg = SimConfig(capacity=2304).to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(n_disk=2100, seed=2), dev)
    st, _ = sim.step(st, cfg)  # warm-up: kernel load, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = sim.step(st, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(st.pos).all()
