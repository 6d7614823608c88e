"""Helpers shared by the tests that hold `nbx_torch` against `nbx`: the same
inputs go to both packages as numpy arrays, and outputs come back as numpy."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from nbx_torch import convert
from nbx_torch.collisions import Draws

# Float32 agreement between the two packages after the same sequence of
# float32 operations: they differ only in summation order and in ulp-level
# library functions (rsqrt, cbrt vs pow), so 1e-5 of the largest magnitude.
FLOAT_TOL = 1e-5

EXACT_STATE_FIELDS = ("mat", "alive", "seq", "next_seq", "step_count")
FLOAT_STATE_FIELDS = ("pos", "vel", "acc", "mass", "temp", "contact")
EVENT_COUNTS = ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped")
EVENT_MASKS = ("merge_mask", "fracture_mask", "spawn_mask")
EVENT_FLOATS = (
    "merge_pos", "merge_mass", "fracture_pos", "fracture_energy",
    "spawn_pos", "spawn_temp",
)


def configs(**kw):
    """(JAX SimConfig, the port's on the CPU) with the same fields."""
    from nbx.config import SimConfig as JaxConfig

    jcfg = JaxConfig(**kw)
    return jcfg, convert.config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)},
                                            "cpu")


def jax_state_arrays(jst) -> dict:
    """The JAX SimState's leaves (all but the key) as numpy arrays."""
    out = {name: np.asarray(getattr(jst, name)) for name in convert.STATE_FIELDS}
    if jst.contact is not None:
        out["contact"] = np.asarray(jst.contact)
    return out


def port_state(jst, cfg, seed: int = 0):
    """The port's SimState holding the same values as the JAX state."""
    return convert.state_from_arrays(jax_state_arrays(jst), cfg, "cpu", seed)


def jax_draws(key, cfg) -> Draws:
    """The fracture uniforms `nbx.collisions.resolve_collisions` draws from
    a state whose key is `key`: the same split chain, rebuilt here."""
    _, sub = jax.random.split(key)
    return fragment_draws(sub, cfg)


def fragment_draws(sub, cfg) -> Draws:
    """The uniforms `nbx.collisions._make_fragments` draws from the key it is
    given (`sub`): split into k_count, k_scan, then fold_in(k_scan, 0..3)."""
    k_count, k_scan = jax.random.split(sub)
    f, k = cfg.max_fractures, cfg.max_fragments
    fold = jax.random.fold_in
    arrays = (
        jax.random.uniform(k_count, (f,)),
        jax.random.uniform(fold(k_scan, 0), (k, f)),
        jax.random.uniform(fold(k_scan, 1), (k, f, 3)),
        jax.random.uniform(fold(k_scan, 2), (k, f)),
        jax.random.uniform(fold(k_scan, 3), (k, f)),
    )
    return Draws(*(torch.from_numpy(np.array(a)) for a in arrays))


def jax_scan_draws(key, cfg, n_steps: int) -> list:
    """The fracture uniforms of each step of
    `nbx.collisions_scaled.granular_full_kdk_scan` from a state whose key is
    `key`: step t draws from key_t (`resolve_collisions_scaled` splits
    key_t -> key_{t+1}, sub; sub feeds the fragments)."""
    out = []
    for _ in range(n_steps):
        out.append(jax_draws(key, cfg))
        key, _ = jax.random.split(key)
    return out


GRANULAR_EXACT = ("mat", "partner")
GRANULAR_FLOATS = ("pos", "vel", "mass", "temp", "contact_t")
SCALED_FLOATS = EVENT_FLOATS


def jax_granular_arrays(jst) -> dict:
    """The JAX GranularState's leaves (all but the key) as numpy arrays."""
    return {name: np.asarray(getattr(jst, name)) for name in convert.GRANULAR_FIELDS}


def port_granular_state(jst, seed: int = 0):
    """The port's GranularState holding the same values as the JAX state."""
    return convert.granular_state_from_arrays(jax_granular_arrays(jst), "cpu", seed)


def assert_granular_matches(st, jst, tol: float = FLOAT_TOL) -> None:
    """Materials and partner records exactly; floats to `tol` of the largest
    magnitude of each field."""
    got = convert.granular_state_to_arrays(st)
    want = jax_granular_arrays(jst)
    for name in GRANULAR_EXACT:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in GRANULAR_FLOATS:
        assert_close(got[name], want[name], name, tol)


def assert_scaled_events_match(ev, jev, tol: float = FLOAT_TOL) -> None:
    """ScaledEvents (one step's, or a stack): counters, flags and masks
    exactly; positions, masses, energies and temperatures to `tol`."""
    for f in dataclasses.fields(ev):
        got = getattr(ev, f.name).cpu().numpy()
        want = np.asarray(getattr(jev, f.name))
        if f.name in SCALED_FLOATS:
            assert_close(got, want, f.name, tol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def assert_totals_match(totals, jtotals) -> None:
    """The scan's totals (counters, max, flags) exactly."""
    assert set(totals) == set(jtotals)
    for k in totals:
        np.testing.assert_array_equal(totals[k].cpu().numpy(), np.asarray(jtotals[k]), err_msg=k)


def assert_close(got, want, what: str, tol: float = FLOAT_TOL) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def assert_state_matches(st, jst, tol: float = FLOAT_TOL) -> None:
    """Slots, insertion order and counters exactly; floats to `tol` of the
    largest magnitude of each field."""
    got = convert.state_to_arrays(st)
    want = jax_state_arrays(jst)
    assert set(got) == set(want)
    for name in EXACT_STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in FLOAT_STATE_FIELDS:
        if name in want:
            assert_close(got[name], want[name], name, tol)


def assert_events_match(ev, jev, tol: float = FLOAT_TOL) -> None:
    """Event counts and masks exactly; event floats to `tol`."""
    for f in dataclasses.fields(ev):
        got = getattr(ev, f.name).numpy()
        want = np.asarray(getattr(jev, f.name))
        if f.name in EVENT_FLOATS:
            assert_close(got, want, f.name, tol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


# ---- the renderer ------------------------------------------------------------------

# Sphere-impostor pixels against the JAX pass run op by op (jax.disable_jit),
# as a fraction of max|HDR|: the impostor's normal is sqrt(1 - d^2),
# ill-conditioned at a disc's rim, and a hot body's crack mask (a steep
# smoothstep of the noise) carries one rounding of d^2 into its heat glow
# (measured: 8.5e-4 on a 300-body hot cluster, 3e-5 on the reference galaxy;
# tests/test_torch_render_fx.py).
IMPOSTOR_TOL = 2e-3


def jax_frame_arrays(jfr) -> dict:
    """The JAX FrameState's fields (the key aside) as numpy arrays, in
    convert.frame_state_from_arrays' layout."""
    return {
        "trails": {k: np.asarray(getattr(jfr.trails, k)) for k in ("pos", "valid", "head")},
        "particles": {k: np.asarray(getattr(jfr.particles, k)) for k in ("pos", "vel", "life", "decay")},
        "lights": {k: np.asarray(getattr(jfr.lights, k)) for k in ("pos", "intensity")},
    }


def jax_camera(jcam, device="cpu"):
    """The port's Camera with the JAX camera's fields."""
    return convert.camera_from_fields(np.asarray(jcam.eye), np.asarray(jcam.target), np.asarray(jcam.up),
                                      float(np.asarray(jcam.fov_deg)), device)


def jax_smoke_draws(key, c: int, pool: int):
    """(new key, the SmokeDraws) `nbx.render.particles.spawn_smoke` draws from
    a pool whose key is `key`, over c bodies: split into six, k1 ... k5."""
    from nbx_torch.render.particles import SmokeDraws

    b = min(c, pool)
    key, k1, k2, k3, k4, k5 = jax.random.split(key, 6)
    arrays = (jax.random.uniform(k1, (c,)), jax.random.normal(k2, (b, 3)), jax.random.uniform(k3, (b,)),
              jax.random.uniform(k4, (b, 3)), jax.random.uniform(k5, (b,)))
    return key, SmokeDraws(*(torch.from_numpy(np.array(a)) for a in arrays))


def jax_explosion_draws(key, f: int):
    """(new key, the ExplosionDraws) `spawn_explosions` draws for f events."""
    from nbx_torch.render.particles import EXPLOSION_COUNT, ExplosionDraws

    n = f * EXPLOSION_COUNT
    key, k1, k2, k3 = jax.random.split(key, 4)
    arrays = (jax.random.normal(k1, (n, 3)), jax.random.uniform(k2, (n,)), jax.random.uniform(k3, (n,)))
    return key, ExplosionDraws(*(torch.from_numpy(np.array(a)) for a in arrays))


def jax_frame_draws(key, c: int, pool: int, f: int):
    """(new key, the FrameDraws) of one `render_and_advance` / `render_granular`
    from a particle pool whose key is `key`: c bodies, f explosion events
    (all substeps' spawn slots)."""
    from nbx_torch.render.pipeline import FrameDraws

    key, smoke = jax_smoke_draws(key, c, pool)
    key, expl = jax_explosion_draws(key, f)
    return key, FrameDraws(smoke, expl)


def assert_frame_state_matches(fr, jfr) -> None:
    """The renderer's state against the JAX FrameState: trails, particles and
    lights to FLOAT_TOL; the trail slots, the particle slots (live, and ever
    written) and the live lights exactly."""
    got, want = convert.frame_state_to_arrays(fr), jax_frame_arrays(jfr)
    np.testing.assert_array_equal(got["trails"]["valid"], want["trails"]["valid"])
    np.testing.assert_array_equal(got["trails"]["head"], want["trails"]["head"])
    assert_close(got["trails"]["pos"], want["trails"]["pos"], "trails.pos")
    np.testing.assert_array_equal(got["particles"]["life"] > 0, want["particles"]["life"] > 0)
    np.testing.assert_array_equal(got["particles"]["decay"] > 0, want["particles"]["decay"] > 0)
    for name in ("pos", "vel", "life", "decay"):
        assert_close(got["particles"][name], want["particles"][name], f"particles.{name}")
    np.testing.assert_array_equal(got["lights"]["intensity"] > 0, want["lights"]["intensity"] > 0)
    for name in ("pos", "intensity"):
        assert_close(got["lights"][name], want["lights"][name], f"lights.{name}")


def assert_hdr_close(got, want, what: str, tol: float = FLOAT_TOL) -> None:
    """An image to `tol` of the reference's largest magnitude, and its
    nonzero-pixel mask exactly."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.any(axis=-1), want.any(axis=-1), err_msg=f"{what}: pixel mask")
    assert_close(got, want, what, tol)



# A tonemapped frame with impostors against the jitted JAX frame: the
# tonemap carries an impostor pixel's rounding through exposure / 0.6 and the
# ACES and gamma slopes onto values in [0, 1]. nbx jitted and nbx run op by op
# differ by up to 1.3e-4 on the galaxy's frames at 160x90; the port by up to
# 3.3e-4 from either. Frames with impostors are held to 1e-3 of their largest
# value; without impostors, to FLOAT_TOL.
IMPOSTOR_FRAME_TOL = 1e-3


def assert_frame_close(got, want, what: str, tol: float = IMPOSTOR_FRAME_TOL) -> None:
    """A tonemapped frame with sphere impostors, to IMPOSTOR_FRAME_TOL."""
    assert_close(got, want, what, tol)
