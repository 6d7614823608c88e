"""disk262k: BASELINE config 4, the N = 262,144 cold-collapse disk, through
the program's frame step.

Set-up: the frozen `cold_collapse_disk` scene from the seed (radius 100,
total mass 1,000, zero velocity), loaded by `nbx_torch.scene.make_state`
into a `SimConfig` with collisions off; a call is `traffic["frames_per_call"]`
frames of `nbx_torch.sim.step` (each `sub_steps` KDK substeps: half-kick,
drift, the direct sum K1 through `sim.gravity`, half-kick, thermal decay).

Judge: `start`, the largest difference between the state the program loaded
and the scene (exactly 0); then, for each judged call, the reference works
out the force at the call's input positions itself (`acc_in`: the widest gap
of the acceleration the program stored there, over its force's scale) and
follows the input positions and velocities from it through the same
substeps in float64 with the direct sum over every body
(`benchmark.reference.gravity.kdk`): `acc_gap` is the widest gap of a body's
output acceleration over its force's scale, `dvel_gap` that of its output
velocity past float32's storage over the kick the scale gives in the call's
time (`reference.gravity.acc_gap`, `dvel_gap`).
"""

from __future__ import annotations

import torch

from benchmark import scenes
from benchmark.harness import Program
from benchmark.reference import gravity as ref


class Disk(Program):
    def __init__(self, ctx):
        from nbx_torch import scene, sim
        from nbx_torch.config import SimConfig

        c = self.c = ctx.config
        self.scene = scenes.cold_collapse_disk(c["n"], c["radius"], c["total_mass"], ctx.seed)
        self.cfg = SimConfig(G=c["G"], softening=c["softening"], dt=c["dt"], sub_steps=c["sub_steps"],
                             capacity=c["n"], collisions=c["collisions"]).to(ctx.device)
        self.state = self.initial = scene.make_state(self.cfg, self.scene, device=ctx.device, seed=ctx.seed)
        self.frames = ctx.traffic["frames_per_call"]
        self.steps_per_call = self.frames * c["sub_steps"]
        self._step = sim.step

    def call(self, state):
        for _ in range(self.frames):
            state, _ = self._step(state, self.cfg)
        return state

    def judge(self, samples: list) -> dict:
        c = self.c
        start = max(float((getattr(self.initial, k).cpu() - torch.from_numpy(self.scene[k])).abs().max())
                    for k in ("pos", "vel", "mass"))
        h = ref.f32(ref.f32(c["dt"]) / c["sub_steps"])
        acc_gap = dvel_gap = 0.0
        steps = self.steps_per_call
        acc_in = 0.0
        for inp, out in samples:
            a0, scale0 = ref.accelerations(inp.pos, inp.mass, inp.pos, c["G"], c["softening"])
            acc_in = max(acc_in, ref.acc_gap(inp.acc, a0, scale0))
            _, vel, acc, scale, mean_scale = ref.kdk(inp.pos, inp.vel, inp.mass, c["G"], c["softening"], h, steps,
                                                     a0=a0)
            acc_gap = max(acc_gap, ref.acc_gap(out.acc, acc, scale))
            dvel_gap = max(dvel_gap, ref.dvel_gap(out.vel, vel, inp.vel, h * steps, 2 * steps, mean_scale))
        return {"start": start, "acc_in": acc_in, "acc_gap": acc_gap, "dvel_gap": dvel_gap}


def setup(ctx) -> Disk:
    return Disk(ctx)
