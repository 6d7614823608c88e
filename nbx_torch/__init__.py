"""nbx_torch — the nbx N-body engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `nbx`, module for module and name for name, held
against it by the tests in `tests/test_torch_*.py`. The frame step
(`sim.step`/`sim.run`, with the Jacobi or the strict-sequential collision
sweep), the host API (`checkpoint`, `interactive.Simulation`, `profiling`,
`python -m nbx_torch run`), the at-scale granular step
(`collisions_scaled.granular_full_kdk_scan`), P3M gravity (`ops.p3m`), the
gravity-only integrators (`integrators`, `bench.drift`) and the spatial
halo-exchange step on `torch.distributed` (`parallel.spatial`) run in eager
PyTorch around hand-written CUDA kernels in `csrc/`, built with nvcc at
first use (`nbx_torch/ops/_build.py`): the strict-sequential collision
sweep (`collide_sequential.cu`), the direct-sum gravity
(`pairwise_f32r.cu`), the fused collision pass, with the spatial step's
gravity-fused variant (`collide_fused.cu`), P3M's
pair passes (`pp_short.cu`, `pp_react.cu`), the acc+jerk sum of the Hermite
scheme (`pairwise_accjerk.cu`) and the per-body potential (`potential.cu`).

This package imports neither `jax` nor `nbx`.
"""

import torch

# Every float32 product in the port is full float32, as the JAX package's
# suite pins its matmuls to "highest": the einsum contractions of
# `forces.accelerations` would otherwise be allowed TF32 (about three decimal
# digits) on the card. Set explicitly, so the result does not depend on
# PyTorch's defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
