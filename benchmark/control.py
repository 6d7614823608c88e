"""The control of `correct`: the program with its own lower-precision path on.

The configurations state float32 forces. The nearest precision below, the
step a later change might be tempted to take, is bfloat16, and the program
has that path itself: `pairwise_acc(precision="bf16")`, the kernel K1e on the
card (`csrc/pairwise_precision.cu`), its plain version on the CPU. `bf16_forces`
switches every direct sum of the cells' entries to it:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace 0 \\
        --patch benchmark.control:bf16_forces

A sound check reads `correct` false on it; the benchmark's own runs never
pass --patch.
"""

from __future__ import annotations

import functools


def bf16_forces() -> None:
    """Route `sim.gravity` (the frame step's force) and the sharded step's
    local sum to the bf16 direct sum, whatever the device."""
    from nbx_torch import sim
    from nbx_torch.ops import pairwise
    from nbx_torch.parallel import shard

    def gravity(pos, mass, G, softening, impl="auto"):
        return pairwise.pairwise_acc(pos, mass, G, softening, precision="bf16")

    sim.gravity = gravity
    shard.pairwise_acc = functools.partial(pairwise.pairwise_acc, precision="bf16")
