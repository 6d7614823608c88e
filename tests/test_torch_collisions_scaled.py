"""nbx_torch.collisions_scaled against nbx.collisions_scaled on the same
states: one collision substep on a merge scene and on a fracture scene, with
one timer slot and with three, and the full KDK loop with PM and dense
gravity. The JAX side runs the Pallas kernel in interpret mode; the fracture
uniforms are rebuilt from the JAX key chain and injected through `draws=`.

Partners, slots, materials, event counts, masks and flags must match exactly;
floats to 1e-5 of each field's largest magnitude (float32 sums in another
order), over a whole scan too."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import collisions_scaled as jcs
from nbx.config import Materials as JaxMaterials
from nbx.config import SimConfig as JaxConfig
from nbx.config import default_materials as jax_default_materials
from nbx_torch import collisions_scaled as cs
from nbx_torch import convert
from nbx_torch.bench import granular
from nbx_torch.config import Materials, f32
from nbx_torch.ops.collide import bucketed_layout_for
from nbx_torch.ops.p3m import p3m_acceleration
from nbx_torch.ops.pm import isolated_green_hat
from torch_parity import (
    assert_granular_matches, assert_scaled_events_match, assert_totals_match,
    jax_draws, jax_scan_draws, port_granular_state,
)

torch.set_num_threads(1)

BOX = 100.0
G_CELLS, BAND = 8, 4


def _configs(fat=False, **kw):
    """The same configuration for both packages; fat=True divides every
    density by 10 (radii x 2.15), a merge-rich cloud."""
    jcfg = JaxConfig(**kw)
    cfg = convert.config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)},
                                     "cpu")
    if fat:
        dm = jax_default_materials()
        jcfg = jcfg.replace(materials=JaxMaterials(density=dm.density * 0.1, color1=dm.color1,
                                                   color2=dm.color2))
        m = cfg.materials
        cfg = cfg.replace(materials=Materials(m.density * 0.1, m.color1, m.color2))
    return jcfg, cfg


def _merge_scene():
    rng = np.random.default_rng(11)
    n = 256
    pos = rng.uniform(20, 60, (n, 3)).astype(np.float32)
    vel = ((40.0 - pos) * 0.05 + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    return (pos, vel, mass), _configs(fat=True, merge_time=0.005, fracture_threshold=1e9)


def _fracture_scene():
    """150 bodies converging fast, 50 dead slots for the fragments."""
    rng = np.random.default_rng(12)
    n, n_live = 200, 150
    pos = np.full((n, 3), 90.0, np.float32)
    pos[:n_live] = rng.uniform(30, 50, (n_live, 3))
    vel = np.zeros((n, 3), np.float32)
    vel[:n_live] = (40.0 - pos[:n_live]) * 0.5 + rng.normal(0, 1.0, (n_live, 3))
    mass = np.zeros(n, np.float32)
    mass[:n_live] = rng.uniform(2.0, 8.0, n_live)
    return (pos, vel, mass), _configs(fracture_threshold=0.5, min_fragment_mass=0.2,
                                      merge_time=1e9)


@pytest.mark.parametrize("timer_slots", [1, 3])
@pytest.mark.parametrize("scene", ["merge", "fracture"])
def test_resolve_collisions_scaled_matches(scene, timer_slots):
    (pos, vel, mass), (jcfg, cfg) = _merge_scene() if scene == "merge" else _fracture_scene()
    buckets = bucketed_layout_for(pos, BOX, G_CELLS, BAND, split_quantile=0.6)
    jst = jcs.make_granular_state(pos, vel, mass, key=3, timer_slots=timer_slots)
    st = port_granular_state(jst)
    h = 0.016
    fired = 0
    for _ in range(2):  # drift, resolve: timers carry across substeps
        jst = jst._replace(pos=jst.pos + jst.vel * h)
        st = st.replace(pos=st.pos + st.vel * f32(h))
        draws = jax_draws(jst.key, jcfg)
        jst, jev = jcs.resolve_collisions_scaled(
            jst, jcfg, h, BOX, G_CELLS, band_cells=BAND, buckets=buckets, interpret=True)
        st, ev = cs.resolve_collisions_scaled(
            st, cfg, f32(h), BOX, G_CELLS, band_cells=BAND, buckets=buckets, draws=draws)
        assert_scaled_events_match(ev, jev)
        assert_granular_matches(st, jst)
        fired += int(ev.n_merges if scene == "merge" else ev.n_fractures)
        assert int(ev.n_overflow) == 0
    assert fired > 0


def _scan_scene():
    """The clustered scene of tests/test_collisions_scaled.py's bucketed
    loop: bounces, merges and fractures within a few steps."""
    rng = np.random.default_rng(9)
    n = 192
    n_bg = n * 2 // 3
    p = np.concatenate([rng.uniform(10, 90, (n_bg, 3)), rng.normal(35.0, 2.5, (n - n_bg, 3))])
    pos = np.clip(p, 1.0, 99.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    mass[::8] = 0.0  # dead slots for fragments
    return pos, vel, mass


@pytest.mark.parametrize("force_impl", ["pm", "dense"])
def test_granular_full_kdk_scan_matches(force_impl):
    pos, vel, mass = _scan_scene()
    jcfg, cfg = _configs(G=0.5, dt=0.016, sub_steps=1, merge_time=0.02, fracture_threshold=4.0)
    buckets = bucketed_layout_for(pos, BOX, G_CELLS, BAND, split_quantile=0.6)
    n_steps = 5
    jst0 = jcs.make_granular_state(pos, vel, mass, key=2)
    kw = dict(n_cells=G_CELLS, band_cells=BAND, buckets=buckets, force_impl=force_impl,
              pm_grid=16, log_events=True)
    jst, jtot, jev = jcs.granular_full_kdk_scan(jst0, jcfg, BOX, n_steps, interpret=True, **kw)
    st, tot, ev = cs.granular_full_kdk_scan(
        port_granular_state(jst0), cfg, BOX, n_steps, draws=jax_scan_draws(jst0.key, jcfg, n_steps),
        **kw)
    assert_totals_match(tot, jtot)
    assert_scaled_events_match(ev, jev)
    assert_granular_matches(st, jst)
    assert int(tot["n_bounces"]) > 0 and int(tot["n_merges"] + tot["n_fractures"]) > 0
    assert ev.n_bounces.shape == (n_steps,)


def test_scan_green_hat_once_per_scene():
    """A precomputed green_hat gives the same steps as the one the scan makes."""
    pos, vel, mass = _scan_scene()
    _, cfg = _configs(G=0.5, dt=0.016, sub_steps=1, merge_time=0.02, fracture_threshold=4.0)
    buckets = bucketed_layout_for(pos, BOX, G_CELLS, BAND)
    kw = dict(n_cells=G_CELLS, band_cells=BAND, buckets=buckets, force_impl="pm", pm_grid=16)
    a, ta = cs.granular_full_kdk_scan(cs.make_granular_state(pos, vel, mass, seed=1, device="cpu"), cfg, BOX, 2,
                                      **kw)
    b, tb = cs.granular_full_kdk_scan(cs.make_granular_state(pos, vel, mass, seed=1, device="cpu"), cfg, BOX, 2,
                                      green_hat=isolated_green_hat(BOX, 16, device="cpu"), **kw)
    np.testing.assert_array_equal(a.pos.numpy(), b.pos.numpy())
    assert int(ta["n_bounces"]) == int(tb["n_bounces"])


@pytest.mark.parametrize("tune", ["overflowing", "bucketed"])
def test_granular_full_kdk_scan_p3m_matches(tune):
    """P3M gravity in the scan, K4 and K5 through their plain versions: 4
    bodies a cell kept, so the clump's cells overflow into the residual
    passes; the bucketed tune splits the cells over two buckets."""
    pos, vel, mass = _scan_scene()
    jcfg, cfg = _configs(G=0.5, dt=0.016, sub_steps=1, merge_time=0.02, fracture_threshold=4.0)
    buckets = bucketed_layout_for(pos, BOX, G_CELLS, BAND, split_quantile=0.6)
    n_steps = 2
    jst0 = jcs.make_granular_state(pos, vel, mass, key=2)
    kw = dict(n_cells=G_CELLS, band_cells=BAND, buckets=buckets, force_impl="p3m", pm_grid=16,
              log_events=True)
    pp_buckets = ((2, 4, 64), (4, 4, 64)) if tune == "bucketed" else None
    jst, jtot, jev = jcs.granular_full_kdk_scan(jst0, jcfg, BOX, n_steps, interpret=True, p3m_cells=4,
                                                p3m_k=4, p3m_max_residual=128, p3m_pp_buckets=pp_buckets,
                                                **kw)
    st, tot, ev = cs.granular_full_kdk_scan(
        port_granular_state(jst0), cfg, BOX, n_steps, draws=jax_scan_draws(jst0.key, jcfg, n_steps),
        p3m=dict(n_cells=4, max_per_cell=4, max_residual=128, pp_buckets=pp_buckets), **kw)
    assert_totals_match(tot, jtot)
    assert_scaled_events_match(ev, jev)
    assert_granular_matches(st, jst)
    assert int(tot["n_bounces"]) > 0 and int(tot["n_uncorrected"]) == 0


def test_scan_rejects_p3m():
    """The two-level residual (ported since this test first raised on it)
    runs at this scene's size; the scan's P3M force takes the dense
    residual, as the JAX scan's does, and refuses parameters it does not
    know, residual_mode among them."""
    pos, vel, mass = _scan_scene()
    acc, unc = p3m_acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, BOX, g=16, n_cells=4,
                                residual_mode="twolevel", sub_g=12, sub_cells=4, sub_k=32)
    assert acc.shape == (pos.shape[0], 3) and bool(torch.isfinite(acc).all()) and unc.dtype == torch.int32
    _, cfg = _configs()
    buckets = bucketed_layout_for(pos, BOX, G_CELLS, BAND)
    _, totals = cs.granular_full_kdk_scan(
        cs.make_granular_state(pos, vel, mass, device="cpu"), cfg, BOX, 1, n_cells=G_CELLS,
        band_cells=BAND, buckets=buckets, force_impl="p3m", pm_grid=16,
        p3m=dict(n_cells=4, max_residual=256))
    assert totals["n_uncorrected"].dtype == torch.int32
    with pytest.raises(ValueError, match="unknown P3M parameters"):
        cs.granular_full_kdk_scan(cs.make_granular_state(pos, vel, mass, device="cpu"), cfg, BOX, 1,
                                  n_cells=G_CELLS, band_cells=BAND, buckets=buckets, force_impl="p3m",
                                  pm_grid=16, p3m=dict(p3m_cells=4))
    with pytest.raises(ValueError, match="unknown P3M parameters"):
        cs.granular_full_kdk_scan(cs.make_granular_state(pos, vel, mass, device="cpu"), cfg, BOX, 1,
                                  n_cells=G_CELLS, band_cells=BAND, buckets=buckets, force_impl="p3m",
                                  pm_grid=16, p3m=dict(residual_mode="twolevel"))


@pytest.mark.parametrize("layout", ["default", "demo_banded"])
def test_scan_layouts_match(layout):
    """The scan with its default layout arguments (full columns, 16 bodies a
    cell) and with the granular demo's banded configuration (its disk with
    the live m = 2000 core, K = 12, direct-sum gravity "auto"; the band, 3,
    does not divide the grid, as the demo's 6 does not divide its 28), a
    few steps against the JAX scan. The grid is 8, not the JAX package's 32
    and 28: its Pallas kernels in interpret mode take minutes a step there."""
    if layout == "default":
        pos, vel, mass = _scan_scene()
        jcfg, cfg = _configs(G=0.5, dt=0.016, sub_steps=1, merge_time=0.02, fracture_threshold=4.0)
        kw, n_steps = dict(n_cells=G_CELLS, force_impl="dense"), 3
    else:
        pos, vel, mass = granular.debris_disk(255, core_mass=2000.0)
        jcfg, cfg = _configs(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0)
        kw, n_steps = dict(n_cells=G_CELLS, max_per_cell=12, band_cells=3, force_impl="auto"), 2
    jst0 = jcs.make_granular_state(pos, vel, mass, key=2)
    jst, jtot, jev = jcs.granular_full_kdk_scan(jst0, jcfg, BOX, n_steps, interpret=True, log_events=True,
                                                **kw)
    st, tot, ev = cs.granular_full_kdk_scan(
        port_granular_state(jst0), cfg, BOX, n_steps, draws=jax_scan_draws(jst0.key, jcfg, n_steps),
        log_events=True, **kw)
    assert_totals_match(tot, jtot)
    assert_scaled_events_match(ev, jev)
    assert_granular_matches(st, jst)
    assert int(tot["n_bounces"]) > 0 and int(tot["n_overflow"]) > 0
    assert bool(tot["cell_too_small"]) == (layout == "demo_banded")  # the core's radius, about 7.8


def test_scan_with_every_default_is_full_columns():
    """granular_full_kdk_scan(st, cfg, box, n) runs the full-column layout at
    16 bodies a cell on a 32^3 grid: the steps of band_cells = 32 (the same
    windows through the other wrapper)."""
    pos, vel, mass = _scan_scene()
    _, cfg = _configs(G=0.5, dt=0.016, sub_steps=1, merge_time=0.02, fracture_threshold=4.0)
    a, ta = cs.granular_full_kdk_scan(cs.make_granular_state(pos, vel, mass, seed=1, device="cpu"), cfg, BOX, 2)
    b, tb = cs.granular_full_kdk_scan(cs.make_granular_state(pos, vel, mass, seed=1, device="cpu"), cfg, BOX, 2,
                                      n_cells=32, max_per_cell=16, band_cells=32, force_impl="auto")
    for f in ("pos", "vel", "mass", "temp", "partner"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert {k: int(v) for k, v in ta.items()} == {k: int(v) for k, v in tb.items()}


def test_granular_state_round_trip():
    pos, vel, mass = _scan_scene()
    jst = jcs.make_granular_state(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
                                  timer_slots=3)
    st = port_granular_state(jst, seed=4)
    assert st.partner.shape == (192, 3) and st.partner.dtype == torch.int32
    back = convert.granular_state_to_arrays(st)
    for name, arr in back.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jst, name)), err_msg=name)
    made = cs.make_granular_state(pos, vel, mass, timer_slots=3, device="cpu")
    for name, arr in convert.granular_state_to_arrays(made).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jst, name)), err_msg=name)
