"""merger1m_allgather: BASELINE config 5's sharded deployment, the
N = 1,048,576 galaxy merger of examples/merger_demo.py stepped by the
all-gather path, one rank a card.

Set-up: the frozen `galaxy_merger` scene from the seed, placed by
`nbx_torch.parallel.shard.shard_state` on `shard.make_mesh` over the ranks
(rank d holds rows [d N/D, (d + 1) N/D)); a call is
`traffic["steps_per_call"]` steps of `shard.make_sharded_step` (half-kick,
drift, the all-gather of positions and masses, K1 of every body on the
rank's rows, half-kick) with h = traffic["h"].

Judge, on each rank for its own rows: `start`, the largest difference
between the rows the program placed and the scene's (exactly 0); then, for
each judged call, every rank's input positions, velocities and masses are
gathered (after the window), each rank works out the force on its rows at
those positions in float64 (`acc_in` for its rows, as for disk262k), the
ranks gather it, and the reference follows the call's steps from it with
the direct sum over all N bodies (`benchmark.reference.gravity.kdk`), the
last step's force on the rank's rows; `acc_gap` and `dvel_gap` as for
disk262k. The harness takes each number's maximum over the ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from benchmark import scenes
from benchmark.harness import Program
from benchmark.reference import gravity as ref


def _gathered(x: torch.Tensor, world: int) -> torch.Tensor:
    if world == 1:
        return x
    out = x.new_empty((world * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous())
    return out


class Sharded(Program):
    def __init__(self, ctx):
        from nbx_torch.parallel import shard

        c, t = self.c, self.t = ctx.config, ctx.traffic
        self.world = ctx.world
        mesh = shard.make_mesh(ctx.world, device_type=ctx.device.type)
        sc = scenes.galaxy_merger(c["n"], c["G"], c["separation"], c["approach_speed"], ctx.seed)
        nl = c["n"] // ctx.world
        self.rows = slice(ctx.rank * nl, (ctx.rank + 1) * nl)
        self.scene = {k: sc[k][self.rows] for k in ("pos", "vel", "mass")}
        self.state = self.initial = shard.shard_state(mesh, sc["pos"], sc["vel"], sc["mass"])
        self.steps_per_call = t["steps_per_call"]
        self._step = shard.make_sharded_step(mesh)

    def call(self, state):
        for _ in range(self.steps_per_call):
            state = self._step(state, self.c["G"], self.c["softening"], self.t["h"])
        return state

    def judge(self, samples: list) -> dict:
        c = self.c
        start = max(float((getattr(self.initial, k).cpu() - torch.from_numpy(self.scene[k])).abs().max())
                    for k in ("pos", "vel", "mass"))
        acc_gap = dvel_gap = 0.0
        acc_in = 0.0
        for inp, out in samples:
            pos, vel, mass = (_gathered(x, self.world) for x in (inp.pos, inp.vel, inp.mass))
            a0_rows, scale0 = ref.accelerations(pos, mass, pos[self.rows], c["G"], c["softening"])
            acc_in = max(acc_in, ref.acc_gap(inp.acc, a0_rows, scale0))
            h, steps = ref.f32(self.t["h"]), self.steps_per_call
            _, vel, acc, scale, mean_scale = ref.kdk(pos, vel, mass, c["G"], c["softening"], h, steps,
                                                     rows=self.rows, a0=_gathered(a0_rows, self.world))
            acc_gap = max(acc_gap, ref.acc_gap(out.acc, acc, scale))
            dvel_gap = max(dvel_gap, ref.dvel_gap(out.vel, vel, inp.vel, h * steps, 2 * steps, mean_scale))
        return {"start": start, "acc_in": acc_in, "acc_gap": acc_gap, "dvel_gap": dvel_gap}


def setup(ctx) -> Sharded:
    return Sharded(ctx)
