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
