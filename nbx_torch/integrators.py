"""Time integrators for pure-gravity systems (port of `nbx/integrators.py`).

The reference's integrate() is a kick-drift-kick velocity-Verlet/leapfrog
(index.html:247-262): half-kick with the *previous* acceleration, drift,
force evaluation, half-kick with the new acceleration. The very first step's
first half-kick is a no-op because Body ctor zeroes acc (index.html:217).

These integrators cover the gravity-only path (Kepler / Plummer / scaling
runs, BASELINE configs 2-4). The full reference step with collisions lives
in `nbx_torch.sim`.

All integrators are functions of (pos, vel, acc) and a force callback of the
JAX package's signatures, and work in any floating dtype (the tests run them
in float64). `run` and `run_hermite` are Python loops in place of
`lax.scan`: they read nothing back from the device, and the per-step
diagnostics stay on the device, stacked at the end.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

ForceFn = Callable[[torch.Tensor], torch.Tensor]  # pos [N,3] -> acc [N,3]
# pos [N,3], vel [N,3] -> (acc [N,3], jerk [N,3])
ForceJerkFn = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


class PhaseState(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor


def kdk_step(s: PhaseState, h: float, force: ForceFn) -> PhaseState:
    """Kick-drift-kick leapfrog, the reference ordering (index.html:247-262)."""
    vel = s.vel + s.acc * (0.5 * h)
    pos = s.pos + vel * h
    acc = force(pos)
    vel = vel + acc * (0.5 * h)
    return PhaseState(pos, vel, acc)


def dkd_step(s: PhaseState, h: float, force: ForceFn) -> PhaseState:
    """Drift-kick-drift leapfrog (same order of accuracy, ablation variant)."""
    pos = s.pos + s.vel * (0.5 * h)
    acc = force(pos)
    vel = s.vel + acc * h
    pos = pos + vel * (0.5 * h)
    return PhaseState(pos, vel, acc)


def symplectic_euler_step(s: PhaseState, h: float, force: ForceFn) -> PhaseState:
    """First-order symplectic Euler (kick then drift) — ablation variant."""
    acc = force(s.pos)
    vel = s.vel + acc * h
    pos = s.pos + vel * h
    return PhaseState(pos, vel, acc)


def explicit_euler_step(s: PhaseState, h: float, force: ForceFn) -> PhaseState:
    """Plain explicit Euler — energy-drifting strawman for the test suite."""
    acc = force(s.pos)
    pos = s.pos + s.vel * h
    vel = s.vel + acc * h
    return PhaseState(pos, vel, acc)


STEPPERS = {
    "kdk": kdk_step,
    "dkd": dkd_step,
    "symplectic_euler": symplectic_euler_step,
    "euler": explicit_euler_step,
}


class HermiteState(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    jerk: torch.Tensor


def init_hermite(pos: torch.Tensor, vel: torch.Tensor, force_jerk: ForceJerkFn) -> HermiteState:
    acc, jerk = force_jerk(pos, vel)
    return HermiteState(pos, vel, acc, jerk)


def hermite_step(s: HermiteState, h: float, force_jerk: ForceJerkFn) -> HermiteState:
    """4th-order Hermite predictor-corrector (Makino & Aarseth 1992): one
    force+jerk evaluation per step, two-point Hermite-interpolation
    corrector; ~h^4 energy error against the leapfrog's h^2."""
    h2 = h * h
    xp = s.pos + s.vel * h + s.acc * (h2 / 2.0) + s.jerk * (h2 * h / 6.0)
    vp = s.vel + s.acc * h + s.jerk * (h2 / 2.0)
    a1, j1 = force_jerk(xp, vp)
    v1 = s.vel + (s.acc + a1) * (h / 2.0) + (s.jerk - j1) * (h2 / 12.0)
    x1 = s.pos + (s.vel + v1) * (h / 2.0) + (s.acc - a1) * (h2 / 12.0)
    return HermiteState(x1, v1, a1, j1)


def _loop(step, s, n_steps: int, diagnostics):
    """n_steps of `step`; returns (final state, diagnostics of every step
    stacked, or None)."""
    outs = []
    for _ in range(n_steps):
        s = step(s)
        if diagnostics is not None:
            outs.append(diagnostics(s))
    return s, (torch.stack(outs) if outs else None)


def run_hermite(
    s: HermiteState,
    h: float,
    n_steps: int,
    force_jerk: ForceJerkFn,
    diagnostics: Callable[[HermiteState], torch.Tensor] | None = None,
):
    """Integrate n_steps of the Hermite scheme. Returns (final_state,
    per-step diagnostics stacked, or None)."""
    return _loop(lambda st: hermite_step(st, h, force_jerk), s, n_steps, diagnostics)


def init_phase(pos: torch.Tensor, vel: torch.Tensor, force: ForceFn | None = None) -> PhaseState:
    """Initial phase state. The reference starts with acc = 0
    (index.html:217) so the first half-kick is a no-op; pass `force` to start
    with a consistent acceleration instead (standard leapfrog warm start)."""
    acc = torch.zeros_like(pos) if force is None else force(pos)
    return PhaseState(pos, vel, acc)


def kahan_add(x: torch.Tensor, c: torch.Tensor, dx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kahan-compensated x + dx with the running compensation c: returns the
    new (x, c). Eager PyTorch evaluates (t - x) - y as written."""
    y = dx - c
    t = x + y
    return t, (t - x) - y


def kdk_compensated_step(
    s: PhaseState, pc: torch.Tensor, vc: torch.Tensor, h: float, force: ForceFn
) -> tuple[PhaseState, torch.Tensor, torch.Tensor]:
    """One KDK step with Kahan-compensated updates; pc and vc are the
    position and velocity compensations, carried from step to step (zeros
    at the start)."""
    v, vc = kahan_add(s.vel, vc, s.acc * (0.5 * h))
    p, pc = kahan_add(s.pos, pc, v * h)
    a = force(p)
    v, vc = kahan_add(v, vc, a * (0.5 * h))
    return PhaseState(p, v, a), pc, vc


def run(
    s: PhaseState,
    h: float,
    n_steps: int,
    force: ForceFn,
    method: str = "kdk",
    diagnostics: Callable[[PhaseState], torch.Tensor] | None = None,
    compensated: bool = False,
):
    """Integrate n_steps. Returns (final_state, per-step diagnostics stacked,
    or None).

    compensated=True (KDK only) uses Kahan-compensated position/velocity
    updates: over 10^4+ steps in float32 the per-step update roundoff
    (~1e-7 |x|) otherwise accumulates into a visible energy-drift floor
    (the Plummer gate, nbx_torch/bench/drift.py).
    """
    if compensated:
        if method != "kdk":
            raise ValueError("compensated integration implemented for kdk only")
        zero = torch.zeros_like(s.pos)
        diag = None if diagnostics is None else (lambda carry: diagnostics(carry[0]))
        (s, _, _), out = _loop(lambda carry: kdk_compensated_step(*carry, h, force),
                               (s, zero, zero), n_steps, diag)
        return s, out

    stepper = STEPPERS[method]
    return _loop(lambda st: stepper(st, h, force), s, n_steps, diagnostics)
